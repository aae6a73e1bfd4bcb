"""Multivariate Gaussian mixture model — fit (EM) and sample (mirrors
:mod:`repro.core.gmm`).

The paper fits a 50-component full-covariance GMM on log-transformed
(rows, cols, bytes) asset observations and exports it to the simulator
(§V-A.1). The port runs that estimator on the device: every E-step goes
through the hand-written CUDA kernel :func:`repro_torch.kernels.gmm_logpdf.
gmm_logpdf` (its plain version on CPU tensors), which takes the inverse
Cholesky factors, computed here by a triangular solve, as the reference
kernel's caller must. The M-step is plain tensor code. The EM loop makes no
host sync: no ``.item()``, no branch on a tensor, and a Cholesky that does
not raise (``cholesky_ex``; a matrix that is not positive definite gives
the NaN factor ``jnp.linalg.cholesky`` gives).

Draws come from an explicit ``torch.Generator``. Each random function is
split into its draw and a deterministic transform of the draw
(:meth:`GMM.sample_transform`, :func:`reject_transform`), and the fit into
its k-means++ init and an EM loop from given means (:func:`em`), so the
tests hold each transform against the reference on the reference's own
draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.gmm_logpdf import gmm_logpdf


@dataclasses.dataclass(frozen=True)
class GMM:
    log_weights: torch.Tensor  # [K]
    means: torch.Tensor        # [K, D]
    chol: torch.Tensor         # [K, D, D] lower Cholesky of covariance

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def to(self, device) -> "GMM":
        return GMM(*(getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)))

    def component_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log N(x | mu_k, Sigma_k) + log w_k for all k.  x: [N, D] -> [N, K]."""
        return component_log_prob(self.log_weights, self.means, self.chol, x)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.logsumexp(self.component_log_prob(x), dim=-1)

    def draw(self, gen: torch.Generator, n: int):
        """The draws of :meth:`sample`: components ``[n]`` (categorical over
        the weights) and standard normals ``[n, D]``."""
        comp = categorical(gen, self.log_weights, n)
        z = torch.randn((n, self.dim), generator=gen, device=gen.device,
                        dtype=self.means.dtype)
        return comp, z

    def sample_transform(self, comp: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
        """``means[comp] + chol[comp] z``: ``[n, D]`` samples from the draws."""
        comp = comp.long()
        return self.means[comp] + torch.einsum("nij,nj->ni", self.chol[comp],
                                               z)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return self.sample_transform(*self.draw(gen, n))


def categorical(gen: torch.Generator, logits: torch.Tensor,
                n=None) -> torch.Tensor:
    """Indices drawn from ``softmax(logits)`` by the Gumbel-max trick (as
    ``jax.random.categorical``): ``[n]`` int64, or a scalar when ``n`` is
    None. No host sync."""
    shape = (() if n is None else (n,)) + tuple(logits.shape)
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def inverse_chol(chol: torch.Tensor) -> torch.Tensor:
    """``[K, D, D]`` inverses of lower Cholesky factors (a triangular
    solve against the identity, as the reference's ``_component_log_prob``)."""
    d = chol.shape[-1]
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand_as(chol)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def component_log_prob(log_w: torch.Tensor, means: torch.Tensor,
                       chol: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` log w_k + log N(x_n | mu_k, L_k L_kᵀ), by the kernel."""
    return gmm_logpdf(x.float().contiguous(), means.contiguous(),
                      inverse_chol(chol).contiguous(), log_w.contiguous())


def cholesky_or_nan(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of ``[K, D, D]`` matrices with
    ``jnp.linalg.cholesky``'s answer for a matrix that is not positive
    definite: NaN on and below the diagonal, zero above. ``cholesky_ex``
    neither raises nor syncs (it leaves a partial factor, replaced here)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    nan_lower = torch.full_like(chol, float("nan")).tril()
    return torch.where((info != 0)[..., None, None], nan_lower, chol)


def kmeanspp_init(gen: torch.Generator, x: torch.Tensor,
                  k: int) -> torch.Tensor:
    """k-means++ seeding for EM means: ``[k, D]`` rows of ``x``."""
    n = x.shape[0]
    first = x.index_select(0, torch.randint(0, n, (1,), generator=gen,
                                            device=gen.device))[0]
    means = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    means[0] = first
    mind = torch.sum((x - first[None]) ** 2, dim=-1)
    for i in range(1, k):
        logits = torch.log(torch.clamp(mind, min=1e-12))
        c = x.index_select(0, categorical(gen, logits)[None])[0]
        means[i] = c
        mind = torch.minimum(mind, torch.sum((x - c[None]) ** 2, dim=-1))
    return means


def em(x: torch.Tensor, means: torch.Tensor, n_iter: int,
       reg: float = 1e-5) -> GMM:
    """``n_iter`` EM iterations for a full-covariance GMM from the given
    initial means (the reference's ``fit_gmm`` after its init): diagonal
    initial covariances from the data's variance, uniform weights."""
    x = x.float()
    n, d = x.shape
    k = means.shape[0]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    var0 = torch.var(x, dim=0, correction=0) + reg
    chol = torch.diag(torch.sqrt(var0))[None].repeat(k, 1, 1)
    log_w = torch.full((k,), -float(torch.log(torch.tensor(float(k)))),
                       dtype=x.dtype, device=x.device)
    means = means.float()
    for _ in range(n_iter):
        logp = component_log_prob(log_w, means, chol, x)          # [N, K]
        logz = torch.logsumexp(logp, dim=1, keepdim=True)
        r = torch.exp(logp - logz)                                # [N, K]
        nk = torch.sum(r, dim=0) + 1e-8                           # [K]
        means_new = (r.T @ x) / nk[:, None]
        diff = x[:, None, :] - means_new[None]                    # [N, K, D]
        cov = torch.einsum("nk,nki,nkj->kij", r, diff, diff) / nk[:, None, None]
        cov = cov + reg * eye[None]
        chol = cholesky_or_nan(cov)
        log_w = torch.log(nk / n)
        means = means_new
    return GMM(log_w, means, chol)


def fit_gmm(gen: torch.Generator, x: torch.Tensor, n_components: int = 50,
            n_iter: int = 60, reg: float = 1e-5) -> GMM:
    """EM for a full-covariance GMM (scikit-learn ``GaussianMixture``
    equivalent; the paper uses K=50, full covariance, on log data), on
    ``x``'s device: k-means++ init from ``gen``, then :func:`em`."""
    x = x.float()
    return em(x, kmeanspp_init(gen, x, n_components), n_iter, reg)


def reject_transform(raw: torch.Tensor, n: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """The deterministic half of :func:`sample_log_gmm_rejecting`: back to
    linear space, the first ``n`` in-bound rows in draw order (a stable
    sort puts accepted rows first), clipped to the bounds for any
    shortfall."""
    val = torch.exp(raw)
    ok = torch.all((val >= lo[None]) & (val <= hi[None]), dim=-1)
    order = torch.argsort((~ok).to(torch.uint8), stable=True)
    picked = val[order[:n]]
    return torch.clamp(picked, min=lo[None], max=hi[None])


def sample_log_gmm_rejecting(gmm: GMM, gen: torch.Generator, n: int,
                             lo: torch.Tensor, hi: torch.Tensor,
                             oversample: int = 4) -> torch.Tensor:
    """Paper §V-A.1: the GMM is fit on log-transformed data; at simulation
    time samples go back to linear space and *out-of-bound values are
    rejected*. Vectorized rejection: draw ``oversample * n``, keep the
    first n in-bound (clipping any shortfall so the shape stays fixed)."""
    return reject_transform(gmm.sample(gen, oversample * n), n, lo, hi)
