"""The port's distribution layer (``repro_torch.core.stats``) against the
JAX package's, on the CPU.

- The host-side fitters are copies: every family's fitted parameters
  equal the reference's exactly in f32.
- ``dist_transform`` on the reference's own ``(u, z)`` draws equals the
  reference's for all five families within 8 f32 ulps of the larger of
  the result and the location parameter (XLA's and torch's ``pow``/
  ``log1p``/``exp`` differ by a few ulps; the Pareto and normal transforms
  add a location, so their ulp is the location's where the sum cancels).
- ``best_fit`` picks the reference's family wherever the reference's best
  SSE beats its runner-up by at least 20 %: the two Monte-Carlo SSE
  estimates come from different generators (``PRNGKey(0)`` there, a CPU
  ``torch.Generator`` seeded 0 here) and differ by a few percent.
- The port's own draws are held statistically against scipy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as ref_stats
from repro_torch.core import stats

FAMILIES = [(stats.LOGNORMAL, (1.5, 0.6, 0.0)),
            (stats.EXPONWEIB, (2.0, 1.5, 30.0)),
            (stats.PARETO, (2.5, -10.0, 10.0)),
            (stats.NORMAL, (3.0, 2.0, 0.0)),
            (stats.EXPONENTIAL, (40.0, 0.0, 0.0))]
ULPS = 8
MARGIN = 0.2


def data_sets():
    rng = np.random.default_rng(0)
    return {"lognormal": rng.lognormal(2.0, 0.5, 3000),
            "weibull": rng.weibull(1.5, 3000) * 30.0,
            "pareto": (rng.pareto(2.5, 3000) + 1.0) * 10.0,
            "exponential": rng.exponential(40.0, 3000)}


@pytest.mark.parametrize("name", ["lognormal", "weibull", "pareto",
                                  "exponential"])
@pytest.mark.parametrize("fam", [stats.LOGNORMAL, stats.EXPONWEIB,
                                 stats.PARETO, stats.NORMAL,
                                 stats.EXPONENTIAL])
def test_fitted_parameters_equal_reference(name, fam):
    x = data_sets()[name]
    want = ref_stats._FITTERS[fam](x)
    got = stats._FITTERS[fam](x)
    assert got.family.dtype == torch.int32 and got.p0.dtype == torch.float32
    for f in ("family", "p0", "p1", "p2"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("fam,p", FAMILIES, ids=lambda v: str(v))
def test_dist_transform_on_reference_draws(fam, p):
    key = jax.random.PRNGKey(fam)
    n = 20000
    u = np.array(jax.random.uniform(key, (n,), minval=1e-7,
                                    maxval=1.0 - 1e-7))
    z = np.array(jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    want = np.asarray(ref_stats.dist_transform(
        jnp.int32(fam), *(jnp.float32(v) for v in p), jnp.asarray(u),
        jnp.asarray(z)))
    got = stats.dist_transform(
        torch.tensor(fam, dtype=torch.int32),
        *(torch.tensor(v, dtype=torch.float32) for v in p),
        torch.from_numpy(u), torch.from_numpy(z)).numpy()
    scale = np.maximum(np.abs(want), np.float32(abs(p[1]))).astype(np.float32)
    stray = ~(np.abs(got - want) <= ULPS * np.spacing(scale))
    assert not stray.any(), stray_report(fam, p, u, z, want, got, stray)


def stray_report(fam, p, u, z, want, got, stray) -> str:
    """What a failure of the transform twin shows: the first stray indices
    with their inputs and both results, which side strays from the f64
    ``exp`` of the f32 argument (the lognormal's ``p0 + p1 z``, rounded
    after the product and after the sum, and fused), the dtypes, and the
    settings that could move a result by an ulp."""
    idx = np.flatnonzero(stray)[:8]
    lines = [f"{int(stray.sum())} of {stray.size} results outside {ULPS} "
             f"ulps; first at {idx.tolist()}",
             f"dtypes: u {u.dtype}, z {z.dtype}, want {want.dtype}, got "
             f"{got.dtype}",
             f"jax_enable_x64={jax.config.jax_enable_x64}, "
             f"torch.get_default_dtype()={torch.get_default_dtype()}, "
             f"torch.get_num_threads()={torch.get_num_threads()}"]
    if fam == stats.LOGNORMAL:
        z32, p0, p1 = z.astype(np.float32), np.float32(p[0]), np.float32(p[1])
        args = {"rounded": (p0 + p1 * z32).astype(np.float32),
                "fused": (np.float64(p0) + np.float64(p1)
                          * z32.astype(np.float64)).astype(np.float32)}
        for how, arg in args.items():
            oracle = np.exp(arg.astype(np.float64))
            ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(
                np.float64)
            off = {side: np.abs(x.astype(np.float64) - oracle) / ulp
                   for side, x in (("port", got), ("reference", want))}
            worse = "port" if off["port"][idx].max() > \
                off["reference"][idx].max() else "reference"
            lines.append(f"from the f64 exp of the {how} f32 argument, in "
                         f"ulps: port {off['port'][idx].round(2).tolist()}, "
                         f"reference {off['reference'][idx].round(2).tolist()}"
                         f": the {worse} strays")
    lines += [f"  [{i}] u={u[i]!r} z={z[i]!r} want={want[i]!r} "
              f"got={got[i]!r}" for i in idx]
    return "\n".join(lines)


def test_sample_equals_reference_dist_sample_on_its_draws():
    """``Dist.sample`` is ``dist_transform`` of ``(u, z)``: on the draws of
    the reference's ``Dist.sample`` with the same key the port's
    transform gives the reference's samples (clustered gather included)."""
    d = ref_stats.stack_dists([ref_stats._scalar_dist(f, *p)
                               for f, p in FAMILIES])
    pd = stats.stack_dists([stats._scalar_dist(f, *p) for f, p in FAMILIES])
    cl = np.random.default_rng(1).integers(0, len(FAMILIES), 4000)
    key = jax.random.PRNGKey(9)
    want = np.asarray(ref_stats.sample_clustered(d, jnp.asarray(cl), key))
    u = np.array(jax.random.uniform(key, cl.shape, minval=1e-7,
                                    maxval=1.0 - 1e-7))
    z = np.array(jax.random.normal(jax.random.fold_in(key, 1), cl.shape))
    c = torch.from_numpy(cl)
    got = stats.dist_transform(pd.family[c], pd.p0[c], pd.p1[c], pd.p2[c],
                               torch.from_numpy(u), torch.from_numpy(z))
    scale = np.maximum(np.abs(want), np.abs(pd.p1[c].numpy()))
    assert (np.abs(got.numpy() - want) <= ULPS * np.spacing(scale)).all()


def test_port_sample_clustered_gathers_per_row():
    """Statistical hold of the port's clustered draws (the reference's
    ``test_clustered_sampling_gather``): each row samples its own
    cluster's distribution; log-means within 0.05."""
    batch = stats.stack_dists([stats._scalar_dist(stats.LOGNORMAL, 0.0, 0.1, 0.0),
                               stats._scalar_dist(stats.LOGNORMAL, 3.0, 0.1, 0.0)])
    cl = torch.from_numpy(np.random.default_rng(0).integers(0, 2, 5000))
    s = stats.sample_clustered(batch, cl, torch.Generator().manual_seed(0))
    ls = np.log(s.numpy())
    assert ls[cl.numpy() == 0].mean() == pytest.approx(0.0, abs=0.05)
    assert ls[cl.numpy() == 1].mean() == pytest.approx(3.0, abs=0.05)


@pytest.mark.parametrize("name", ["lognormal", "weibull", "pareto",
                                  "exponential"])
def test_best_fit_agrees_where_reference_is_clear(name):
    x = data_sets()[name]
    fams = (stats.LOGNORMAL, stats.EXPONWEIB, stats.PARETO)
    sse = {}
    for f in fams:
        try:
            s = ref_stats.histogram_sse(x, ref_stats._FITTERS[f](x))
        except Exception:      # the reference skips a family that fails
            continue
        if np.isfinite(s):
            sse[f] = s
    ranked = sorted(sse, key=sse.get)
    got = stats.best_fit(x, fams)
    want = ref_stats.best_fit(x, fams)
    if len(ranked) == 1 or sse[ranked[0]] < (1 - MARGIN) * sse[ranked[1]]:
        assert int(got.family) == int(want.family) == ranked[0]
    else:                      # a near tie: either of the two leaders
        assert int(got.family) in ranked[:2]


def test_histogram_sse_is_deterministic():
    """The Monte-Carlo sample is seeded 0 on every call, as the
    reference's ``PRNGKey(0)``."""
    x = data_sets()["weibull"]
    d = stats.fit_exponweib(x)
    assert stats.histogram_sse(x, d) == stats.histogram_sse(x, d)


@pytest.mark.parametrize("fam,p", FAMILIES, ids=lambda v: str(v))
def test_port_draws_match_scipy_quantiles(fam, p):
    """Statistical hold of the port's own draws: 40,000 samples' quantiles
    (10 %..90 %) within 4 % of the distribution's, or within 0.05 of the
    scale for the normal's quantiles near zero."""
    from scipy import stats as sps
    dists = {stats.LOGNORMAL: sps.lognorm(p[1], scale=np.exp(p[0])),
             stats.EXPONWEIB: sps.exponweib(p[0], p[1], scale=p[2]),
             stats.PARETO: sps.pareto(p[0], loc=p[1], scale=p[2]),
             stats.NORMAL: sps.norm(p[0], p[1]),
             stats.EXPONENTIAL: sps.expon(scale=p[0])}
    s = stats._scalar_dist(fam, *p).sample(torch.Generator().manual_seed(fam),
                                           (40000,)).numpy()
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        want = dists[fam].ppf(q)
        assert np.quantile(s, q) == pytest.approx(want, rel=0.04, abs=0.05)


def test_stack_and_qq_stats():
    a = stats.stack_dists([stats.fit_lognormal(np.array([1.0, 2.0, 4.0])),
                           stats.fit_normal(np.array([1.0, 2.0]))])
    assert a.family.tolist() == [stats.LOGNORMAL, stats.NORMAL]
    assert a.name == "clustered[(2,)]"
    rng = np.random.default_rng(3)
    x, y = rng.lognormal(1.0, 0.5, 5000), rng.lognormal(1.2, 0.7, 5000)
    assert stats.qq_stats(x, y) == ref_stats.qq_stats(x, y)
