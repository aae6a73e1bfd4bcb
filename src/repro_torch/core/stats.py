"""Statistical distributions for trace-driven simulation (mirrors
:mod:`repro.core.stats`; paper §V-A).

The paper's pattern: fit distributions with scipy *offline*, export the
parameters, and *sample* inside the simulator. The split stays:

  - ``fit_*`` functions run on the host (numpy/scipy) on empirical trace
    arrays, copied from the reference;
  - every fitted family is a :class:`Dist` — a ``(family, p0, p1, p2)``
    record of tensors that samples by a branchless inverse-CDF transform,
    :func:`dist_transform`, so per-cluster sampling (168 hour-of-week
    clusters) is a gather and one elementwise pass on the device.

Draws come from an explicit ``torch.Generator`` (on the device that
samples). ``torch.Generator`` cannot reproduce ``jax.random``'s threefry
bits, so the draws are held to the reference statistically, and the
transform from ``(u, z)`` draws to samples is held against the reference
on the reference's own draws.

Families (ids are serialized and must stay stable):
  0 LOGNORMAL   x = exp(p0 + p1 * z)                      (p2 unused)
  1 EXPONWEIB   F(x) = (1 - exp(-(x/p2)**p1))**p0  -> ppf
  2 PARETO      x = p1 + p2 * (1-u)**(-1/p0)             (scipy param.)
  3 NORMAL      x = p0 + p1 * z
  4 EXPONENTIAL x = -p0 * log1p(-u)                       (p0 = scale)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

LOGNORMAL, EXPONWEIB, PARETO, NORMAL, EXPONENTIAL = 0, 1, 2, 3, 4

_FAMILY_NAMES = {
    LOGNORMAL: "lognormal",
    EXPONWEIB: "exponweib",
    PARETO: "pareto",
    NORMAL: "normal",
    EXPONENTIAL: "exponential",
}

# uniform draws stay inside (0, 1), as the reference's
U_LO, U_HI = 1e-7, 1.0 - 1e-7


@dataclasses.dataclass(frozen=True)
class Dist:
    """A (batched) parametric distribution: four tensors on one device,
    ``family`` int32 and ``p0``/``p1``/``p2`` float32, scalar or ``[C]``."""

    family: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @property
    def name(self) -> str:
        if self.family.dim() == 0:
            return _FAMILY_NAMES[int(self.family)]
        return f"clustered[{tuple(self.family.shape)}]"

    def to(self, device) -> "Dist":
        return Dist(*(getattr(self, f.name).to(device)
                      for f in dataclasses.fields(self)))

    def sample(self, gen: torch.Generator, shape=()) -> torch.Tensor:
        """Draw samples on ``gen``'s device; ``self`` must be
        scalar-parameterized and on that device."""
        u, z = draw_uz(gen, shape)
        return dist_transform(self.family, self.p0, self.p1, self.p2, u, z)

    def mean_estimate(self, gen: torch.Generator, n: int = 20000) -> float:
        return float(self.sample(gen, (n,)).mean())


def draw_uz(gen: torch.Generator, shape):
    """The two draws every transform consumes: ``u`` uniform in
    ``[U_LO, U_HI)`` and ``z`` standard normal, f32 on ``gen``'s device."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    u = torch.rand(shape, generator=gen, device=gen.device) \
        * (U_HI - U_LO) + U_LO
    z = torch.randn(shape, generator=gen, device=gen.device)
    return u, z


def dist_transform(family, p0, p1, p2, u, z) -> torch.Tensor:
    """Branchless inverse-CDF / reparameterized transform (broadcasts), op
    for op the reference's: every family is evaluated and ``family``
    selects."""
    ln = torch.exp(p0 + p1 * z)
    a = torch.clamp(p0, min=1e-6)
    c = torch.clamp(p1, min=1e-6)
    scale = torch.clamp(p2, min=1e-30)
    inner = -torch.log1p(-torch.pow(u, 1.0 / a))
    ew = scale * torch.pow(torch.clamp(inner, min=1e-30), 1.0 / c)
    par = p1 + torch.clamp(p2, min=1e-30) * torch.pow(
        1.0 - u, -1.0 / torch.clamp(p0, min=1e-6))
    nrm = p0 + p1 * z
    expo = -torch.clamp(p0, min=1e-30) * torch.log1p(-u)
    out = torch.where(family == LOGNORMAL, ln, torch.zeros_like(ln))
    out = torch.where(family == EXPONWEIB, ew, out)
    out = torch.where(family == PARETO, par, out)
    out = torch.where(family == NORMAL, nrm, out)
    out = torch.where(family == EXPONENTIAL, expo, out)
    return out


def sample_clustered(dist: Dist, cluster: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    """Sample ``x[i] ~ dist[cluster[i]]`` for a batched :class:`Dist` (one
    gather)."""
    c = cluster.long()
    u, z = draw_uz(gen, tuple(cluster.shape))
    return dist_transform(dist.family[c], dist.p0[c], dist.p1[c],
                          dist.p2[c], u, z)


# ---------------------------------------------------------------------------
# Host-side fitting (scipy), copied from the reference.
# ---------------------------------------------------------------------------

def fit_lognormal(x: np.ndarray) -> Dist:
    lx = np.log(np.maximum(np.asarray(x, np.float64), 1e-12))
    return _scalar_dist(LOGNORMAL, float(lx.mean()), float(lx.std() + 1e-9), 0.0)


def fit_normal(x: np.ndarray) -> Dist:
    x = np.asarray(x, np.float64)
    return _scalar_dist(NORMAL, float(x.mean()), float(x.std() + 1e-9), 0.0)


def fit_exponential(x: np.ndarray) -> Dist:
    return _scalar_dist(EXPONENTIAL, float(np.mean(x)), 0.0, 0.0)


def fit_exponweib(x: np.ndarray) -> Dist:
    from scipy import stats as sps

    x = np.asarray(x, np.float64)
    a, c, _loc, scale = sps.exponweib.fit(x, floc=0.0)
    return _scalar_dist(EXPONWEIB, float(a), float(c), float(scale))


def fit_pareto(x: np.ndarray) -> Dist:
    from scipy import stats as sps

    x = np.asarray(x, np.float64)
    b, loc, scale = sps.pareto.fit(x)
    return _scalar_dist(PARETO, float(b), float(loc - scale), float(scale))


_FITTERS = {
    LOGNORMAL: fit_lognormal,
    EXPONWEIB: fit_exponweib,
    PARETO: fit_pareto,
    NORMAL: fit_normal,
    EXPONENTIAL: fit_exponential,
}


def _scalar_dist(family: int, p0: float, p1: float, p2: float) -> Dist:
    """A scalar :class:`Dist` on the CPU, its parameters rounded to f32 as
    the reference's."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    return Dist(torch.tensor(family, dtype=torch.int32), f32(p0), f32(p1),
                f32(p2))


def histogram_sse(x: np.ndarray, dist: Dist, bins: int = 60,
                  n_mc: int = 30000) -> float:
    """Sum-of-squared-errors between the empirical histogram density and the
    fitted density (estimated by a Monte-Carlo histogram on the same bins)
    — the paper's model-selection criterion (§V-A.3). The Monte-Carlo
    sample comes from a CPU generator seeded 0 on every call, as the
    reference draws from ``PRNGKey(0)`` on every call."""
    x = np.asarray(x, np.float64)
    lo, hi = np.percentile(x, [0.5, 99.5])
    if hi <= lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    emp, _ = np.histogram(x, bins=edges, density=True)
    s = dist.to("cpu").sample(torch.Generator().manual_seed(0),
                              (n_mc,)).numpy()
    s = s[np.isfinite(s)]
    mod, _ = np.histogram(s, bins=edges, density=True)
    return float(np.sum((emp - mod) ** 2))


def best_fit(x: np.ndarray,
             candidates: Sequence[int] = (LOGNORMAL, EXPONWEIB, PARETO)
             ) -> Dist:
    """Fit every candidate family and keep the lowest-SSE one (paper
    §V-A.3)."""
    best, best_sse = None, np.inf
    for fam in candidates:
        try:
            d = _FITTERS[fam](x)
            sse = histogram_sse(x, d)
        except Exception:  # a family can fail to converge on odd strata
            continue
        if np.isfinite(sse) and sse < best_sse:
            best, best_sse = d, sse
    if best is None:
        best = fit_lognormal(x)
    return best


def stack_dists(dists: Sequence[Dist]) -> Dist:
    """Stack scalar Dists into a batched (clustered) Dist."""
    return Dist(*(torch.stack([getattr(d, f) for d in dists])
                  for f in ("family", "p0", "p1", "p2")))


# ---------------------------------------------------------------------------
# Q-Q agreement (Fig 12 machinery): quantile comparison between two samples.
# ---------------------------------------------------------------------------

def qq_stats(empirical: np.ndarray, simulated: np.ndarray,
             n_q: int = 99) -> dict:
    """Quantile-quantile agreement in log10-space, as plotted in Fig 12:
    R^2 of the Q-Q scatter against the y=x line plus the max and mean abs
    deviation (log10 seconds)."""
    qs = np.linspace(0.01, 0.99, n_q)
    e = np.log10(np.maximum(np.quantile(np.asarray(empirical, np.float64), qs), 1e-9))
    s = np.log10(np.maximum(np.quantile(np.asarray(simulated, np.float64), qs), 1e-9))
    ss_res = float(np.sum((e - s) ** 2))
    ss_tot = float(np.sum((e - e.mean()) ** 2)) + 1e-12
    return {
        "r2": 1.0 - ss_res / ss_tot,
        "max_abs_dev_log10": float(np.max(np.abs(e - s))),
        "mean_abs_dev_log10": float(np.mean(np.abs(e - s))),
    }
