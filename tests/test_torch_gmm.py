"""The port's GMM layer against the JAX package, on the CPU.

- The ``gmm_logpdf`` wrapper (its plain version on CPU tensors) against
  ``repro.kernels.ref.gmm_logpdf_ref`` and the Pallas kernel in interpret
  mode (``repro.kernels.ops.gmm_logpdf``), at ``tests/test_kernels.py``'s
  shapes and more, to that test's atol 5e-4.
- ``component_log_prob`` against the reference's ``_component_log_prob``.
- EM: the port's loop started from the reference's own k-means++ means,
  against the reference's ``fit_gmm`` with the same key. The port's
  ``logdet`` comes from the inverse factor (the kernel's), not from the
  factor, so agreement is to f32 rounding carried through the iterations,
  about 1e-5 relative: held to rtol 1e-4.
- The sample and rejection transforms on the reference's own draws.

``torch.Generator`` cannot reproduce ``jax.random``'s bits, so every
transform is fed the reference's draws, and the draws themselves are held
statistically (``test_draws_*``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as ref_gmm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch.core import gmm
from repro_torch.kernels.gmm_logpdf import gmm_logpdf

ATOL = 5e-4          # tests/test_kernels.py's tolerance for this kernel


def t(a):
    return torch.from_numpy(np.array(a))


def kernel_case(rng, N, D, K):
    """tests/test_kernels.py's construction: unit-diagonal lower factors
    with N(0, 0.2) below, their exact inverses, uniform weights."""
    x = rng.normal(0, 1, (N, D)).astype(np.float32)
    mu = rng.normal(0, 1, (K, D)).astype(np.float32)
    L = np.tril(rng.normal(0, 0.2, (K, D, D))) + np.eye(D)[None]
    inv = np.linalg.inv(L).astype(np.float32)
    lw = np.log(np.ones(K) / K).astype(np.float32)
    return x, mu, inv, lw


@pytest.mark.parametrize("N,D,K", [(256, 2, 4), (512, 3, 16), (300, 8, 8),
                                   (1, 1, 1), (1000, 1, 6), (2000, 3, 50)])
def test_plain_kernel_matches_reference_ref(N, D, K):
    x, mu, inv, lw = kernel_case(np.random.default_rng(N + D + K), N, D, K)
    want = np.asarray(ref_kernels.gmm_logpdf_ref(
        *(jnp.asarray(a) for a in (x, mu, inv, lw))))
    got = gmm_logpdf(t(x), t(mu), t(inv), t(lw))
    assert got.shape == (N, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("N,D,K", [(256, 2, 4), (512, 3, 16), (300, 8, 8)])
def test_plain_kernel_matches_pallas_interpret(N, D, K):
    """The Pallas kernel itself (interpret mode on the CPU), with a block
    that leaves a ragged last tile."""
    x, mu, inv, lw = kernel_case(np.random.default_rng(7 * N + K), N, D, K)
    want = np.asarray(ref_ops.gmm_logpdf(
        *(jnp.asarray(a) for a in (x, mu, inv, lw)), block_n=128,
        interpret=True))
    got = gmm_logpdf(t(x), t(mu), t(inv), t(lw))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_wrapper_refuses_bad_inputs():
    x, mu, inv, lw = (t(a) for a in kernel_case(np.random.default_rng(0),
                                                 8, 2, 3))
    with pytest.raises(ValueError, match="inv_chol"):
        gmm_logpdf(x, mu, inv[:, :1], lw)
    with pytest.raises(TypeError, match="float32"):
        gmm_logpdf(x.double(), mu, inv, lw)
    with pytest.raises(ValueError, match="means"):
        gmm_logpdf(x, mu[:, :1], inv, lw)


def fitted_reference(n_comp=5, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(-2, 0.5, (300, 3)),
                        rng.normal(2, 0.8, (300, 3))]).astype(np.float32)
    g = ref_gmm.fit_gmm(jax.random.PRNGKey(seed), jnp.asarray(x), n_comp, 20)
    return x, g


def port_gmm(g):
    return gmm.GMM(*(t(np.asarray(a)) for a in (g.log_weights, g.means,
                                                g.chol)))


def test_component_log_prob_matches_reference():
    """Through the kernel's plain version, from the factor (the port
    inverts it by a triangular solve): within the kernel's atol."""
    x, g = fitted_reference()
    want = np.asarray(ref_gmm._component_log_prob(
        g.log_weights, g.means, g.chol, jnp.asarray(x)))
    pg = port_gmm(g)
    np.testing.assert_allclose(pg.component_log_prob(t(x)).numpy(), want,
                               atol=ATOL)
    np.testing.assert_allclose(pg.log_prob(t(x)).numpy(),
                               np.asarray(g.log_prob(jnp.asarray(x))),
                               atol=ATOL)


EM_RTOL, EM_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("N,D,K,n_iter", [(600, 3, 4, 10), (400, 1, 3, 50)])
def test_em_from_reference_init_matches_fit_gmm(N, D, K, n_iter):
    rng = np.random.default_rng(N + D)
    x = np.concatenate([rng.normal(m, 0.5 + 0.3 * i, (N // 2, D))
                        for i, m in enumerate((-2.0, 2.0))]).astype(np.float32)
    key = jax.random.PRNGKey(N)
    want = ref_gmm.fit_gmm(key, jnp.asarray(x), K, n_iter)
    means0 = np.asarray(ref_gmm._kmeanspp_init(key, jnp.asarray(x), K))
    got = gmm.em(t(x), t(means0), n_iter)
    for name in ("log_weights", "means", "chol"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=EM_RTOL, atol=EM_ATOL, err_msg=name)


def test_cholesky_nan_where_reference_is_nan():
    """The M-step's factor: equal to ``jnp.linalg.cholesky`` on positive
    definite matrices (rtol 1e-6), and NaN exactly where that gives NaN
    (on and below the diagonal of a matrix that is not positive definite;
    zero above), with no raise."""
    rng = np.random.default_rng(5)
    a = rng.normal(0, 1, (4, 3, 3)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    cov[1] = np.diag([1.0, -1.0, 1.0])          # indefinite
    cov[3] = np.zeros((3, 3))                   # singular
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(cov)))
    got = gmm.cholesky_or_nan(t(cov)).numpy()
    assert np.isnan(want[[1, 3]]).any((1, 2)).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[[1, 3]][~np.isnan(got[[1, 3]])],
                          want[[1, 3]][~np.isnan(want[[1, 3]])])
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-6,
                               atol=1e-7)


def test_sample_transform_on_reference_draws():
    """``means[comp] + chol[comp] z`` on the reference's (comp, z) equals
    the reference's ``GMM.sample`` with the same key."""
    _, g = fitted_reference()
    key = jax.random.PRNGKey(3)
    n = 500
    want = np.asarray(g.sample(key, n))
    kc, kz = jax.random.split(key)
    comp = np.asarray(jax.random.categorical(kc, g.log_weights, shape=(n,)))
    z = np.asarray(jax.random.normal(kz, (n, g.means.shape[1])))
    got = port_gmm(g).sample_transform(t(comp), t(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_reject_transform_on_reference_draws():
    """The rejection sampler's transform (exp, in-bound mask, stable
    order, clip) on the reference's raw draws equals
    ``sample_log_gmm_rejecting``; bounds are set so that some draws are
    rejected and the first n accepted ones are kept in draw order."""
    _, g = fitted_reference()
    key = jax.random.PRNGKey(4)
    n, over = 300, 4
    lo = np.array([0.1, 0.1, 0.1], np.float32)
    hi = np.array([10.0, 10.0, 10.0], np.float32)
    want = np.asarray(ref_gmm.sample_log_gmm_rejecting(
        g, key, n, jnp.asarray(lo), jnp.asarray(hi), oversample=over))
    raw = np.asarray(g.sample(key, over * n))
    assert 0 < (~np.all((np.exp(raw) >= lo) & (np.exp(raw) <= hi), 1)).sum()
    got = gmm.reject_transform(t(raw), n, t(lo), t(hi))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_draws_sample_the_mixture():
    """Statistical hold of the port's own draws: 20,000 samples of a
    two-component 1-D mixture have its weights (within 0.02) and its
    component means (within 0.05)."""
    g = gmm.GMM(torch.log(torch.tensor([0.3, 0.7])),
                torch.tensor([[-3.0], [4.0]]),
                torch.tensor([[[0.5]], [[1.0]]]))
    s = g.sample(torch.Generator().manual_seed(0), 20000)[:, 0].numpy()
    left = s < 0.5
    assert left.mean() == pytest.approx(0.3, abs=0.02)
    assert s[left].mean() == pytest.approx(-3.0, abs=0.05)
    assert s[~left].mean() == pytest.approx(4.0, abs=0.05)


def test_draws_kmeanspp_and_fit_recover_modes():
    """The port's own init + EM recover two separated 2-D modes and equal
    weights (the reference's ``test_gmm_em_recovers_two_modes``)."""
    rng = np.random.default_rng(1234)
    n = 3000
    x = np.concatenate([rng.normal([-3, 0], 0.4, (n, 2)),
                        rng.normal([3, 1], 0.6, (n, 2))]).astype(np.float32)
    g = gmm.fit_gmm(torch.Generator().manual_seed(0), t(x), 2, 80)
    mus = np.sort(g.means[:, 0].numpy())
    assert mus[0] == pytest.approx(-3.0, abs=0.15)
    assert mus[1] == pytest.approx(3.0, abs=0.15)
    assert torch.exp(g.log_weights).min() > 0.4


def test_public_wrapper_matches_pallas_kernel_and_takes_no_tiles():
    """``repro_torch.kernels.ops.gmm_logpdf`` against the reference's public
    wrapper (interpret mode); a tile argument is refused, not ignored."""
    from repro_torch.kernels import ops as tops
    x, mu, inv, lw = kernel_case(np.random.default_rng(11), 300, 3, 5)
    want = np.asarray(ref_ops.gmm_logpdf(
        *(jnp.asarray(a) for a in (x, mu, inv, lw)), block_n=128,
        interpret=True))
    got = tops.gmm_logpdf(t(x), t(mu), t(inv), t(lw))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with pytest.raises(TypeError):
        tops.gmm_logpdf(t(x), t(mu), t(inv), t(lw), block_n=128)
