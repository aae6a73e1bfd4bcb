"""The port's Mamba-2 block and SSD scan against the reference's, on the CPU.

Inputs are made with numpy from a seed at the reference kernel test's
scales (x * 0.5, B/C * 0.3, dt = softplus(.) * 0.1, A = -exp(. * 0.3)) and
handed to both packages. Tolerances: the chunked scan and the block in f32
within 1e-5 (values of order 0.1-1; the two frameworks sum in other
orders); the kernel's plain version against the reference's Pallas kernel
(interpret mode) and the O(S) recurrence within 2e-4, the atol of
``tests/test_kernels.py``'s SSD sweep (chunked and step-by-step sums of up
to 256 terms differ by more than f32 rounding of one sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm, weights

ATOL = 1e-5
SCAN_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are small: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def softplus(a):
    return np.log1p(np.exp(-np.abs(a))) + np.maximum(a, 0.0)


def ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P) * 0.5
    dt = (softplus(f(B, S, H)) * 0.1).astype(np.float32)
    A = -np.exp(f(H) * 0.3).astype(np.float32)
    Bm = f(B, S, N) * 0.3
    Cm = f(B, S, N) * 0.3
    return x, dt, A, Bm, Cm


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("S,chunk,with_h0", [
    (32, 8, False), (30, 8, False), (30, 8, True), (64, 16, True),
    (5, 8, False)])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    B, H, P, N = 2, 3, 8, 4
    x, dt, A, Bm, Cm = ssd_inputs(S, B, S, H, P, N)
    h0 = (np.random.default_rng(7).standard_normal((B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    yw, hw = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              h0=None if h0 is None else jnp.asarray(h0),
                              chunk=chunk)
    yg, hg = ssm.ssd_chunked(*(t(a) for a in (x, dt, A, Bm, Cm)),
                             h0=None if h0 is None else t(h0), chunk=chunk)
    assert yg.shape == (B, S, H, P) and hg.shape == (B, H, P, N)
    assert yg.dtype == hg.dtype == torch.float32
    close(yg, yw, ATOL)
    close(hg, hw, ATOL)


def mamba_params(seed, D=32, N=8, P=8):
    p = jssm.init_mamba2(jax.random.PRNGKey(seed), D, N, P)[0]
    tree = jax.tree_util.tree_map(np.asarray, p)
    # a non-zero conv bias and dt bias, so both reach the twins
    rng = np.random.default_rng(seed)
    tree["conv_b"] = (rng.standard_normal(tree["conv_b"].shape) * 0.1
                      ).astype(np.float32)
    tree["dt_bias"] = (rng.standard_normal(tree["dt_bias"].shape) * 0.5
                       ).astype(np.float32)
    return tree


@pytest.mark.parametrize("S,cached,impl", [
    (16, False, "xla"), (16, False, "mamba_kernel"), (13, False, "xla"),
    (12, True, "xla"), (12, True, "mamba_kernel"), (1, True, "xla"),
    (1, False, "xla")])
def test_apply_mamba2_matches_reference(S, cached, impl):
    """S > 1 runs the chunked scan (the kernel's plain version under
    ``mamba_kernel`` with no state), S = 1 the recurrence; the output and
    the new conv and SSM states equal the reference's."""
    D, N, P, B, chunk = 32, 8, 8, 2, 8
    tree = mamba_params(S, D, N, P)
    d_inner, H = 2 * D, 2 * D // P
    rng = np.random.default_rng(100 + S)
    x = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    state = None
    if cached:
        state = {"conv": (rng.standard_normal((B, 3, d_inner + 2 * N)) * 0.5
                          ).astype(np.float32),
                 "ssm": (rng.standard_normal((B, H, P, N)) * 0.3
                         ).astype(np.float32)}
    kw = dict(d_state=N, head_dim=P, chunk=chunk, impl=impl)
    yw, sw = jssm.apply_mamba2(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        state=None if state is None else jax.tree_util.tree_map(jnp.asarray,
                                                                state), **kw)
    yg, sg = ssm.apply_mamba2(
        weights.from_reference(tree, device="cpu"), t(x),
        state=None if state is None else {k: t(v) for k, v in state.items()},
        **kw)
    assert yg.shape == (B, S, D)
    assert sg["ssm"].dtype == torch.float32
    close(yg, yw, ATOL)
    close(sg["conv"], sw["conv"], ATOL)
    close(sg["ssm"], sw["ssm"], ATOL)


SCAN_SHAPES = [(128, 2, 64, 32, 64), (256, 4, 32, 64, 128),
               (192, 1, 64, 64, 64)]


@pytest.mark.parametrize("S,H,P,N,chunk", SCAN_SHAPES)
def test_mamba2_scan_plain_matches_reference_kernel(S, H, P, N, chunk):
    """``tests/test_kernels.py``'s SSD sweep: the port's public wrapper on
    CPU tensors (the plain version) against the reference's Pallas kernel
    in interpret mode and the reference's recurrence, within 2e-4."""
    args = ssd_inputs(S + H, 2, S, H, P, N)
    yg, hg = ops.mamba2_scan(*(t(a) for a in args), chunk=chunk)
    yk, hk = jops.mamba2_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                              interpret=True)
    yr, hr = jref.mamba2_recurrent_ref(*(jnp.asarray(a) for a in args))
    for got, want in ((yg, yk), (hg, hk), (yg, yr), (hg, hr)):
        close(got, want, SCAN_ATOL)


def test_mamba2_recurrent_ref_matches_reference():
    args = ssd_inputs(3, 2, 64, 2, 8, 16)
    yg, hg = ref.mamba2_recurrent_ref(*(t(a) for a in args))
    yw, hw = jref.mamba2_recurrent_ref(*(jnp.asarray(a) for a in args))
    close(yg, yw, ATOL)
    close(hg, hw, ATOL)


def test_mamba2_chunk_invariance():
    args = [t(a) for a in ssd_inputs(9, 1, 256, 2, 32, 32)]
    y1, h1 = ops.mamba2_scan(*args, chunk=64)
    y2, h2 = ops.mamba2_scan(*args, chunk=128)
    close(y1, y2.numpy(), SCAN_ATOL)
    close(h1, h2.numpy(), SCAN_ATOL)


def test_mamba2_scan_takes_bf16_and_returns_f32():
    args = [t(a) for a in ssd_inputs(4, 1, 32, 2, 8, 8)]
    bf = [a.to(torch.bfloat16) if i != 2 else a for i, a in enumerate(args)]
    y, h = ops.mamba2_scan(*bf, chunk=16)
    assert y.dtype == h.dtype == torch.float32
    want, _ = ref.mamba2_recurrent_ref(*bf)
    close(y, want.numpy(), SCAN_ATOL)


def test_mamba2_scan_refuses_ragged_s_and_grad():
    x, dt, A, Bm, Cm = (t(a) for a in ssd_inputs(5, 1, 100, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.mamba2_scan(x, dt, A, Bm, Cm, chunk=64)
    # S below the chunk: the chunk shrinks to S, as in the reference
    y, _ = ops.mamba2_scan(x, dt, A, Bm, Cm, chunk=128)
    assert y.shape == x.shape
    with pytest.raises(RuntimeError, match='requires grad.*ssm_impl="xla"'):
        ops.mamba2_scan(x.requires_grad_(), dt, A, Bm, Cm, chunk=50)
    with torch.no_grad():       # nothing to record: the scan runs
        ops.mamba2_scan(x, dt, A, Bm, Cm, chunk=50)
    with pytest.raises(ValueError, match="dt must be"):
        ops.mamba2_scan(x.detach(), dt[:, :-1], A, Bm, Cm, chunk=50)
