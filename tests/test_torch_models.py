"""The port's model pieces against the reference's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages; outputs must agree to f32 rounding (1e-5 absolute on values of
order one: the two frameworks sum in other orders, and XLA and torch
compute ``pow``/``cos``/``sin`` to within an ulp of each other).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.models import attention, common

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, g = arrays(1, (2, 5, 32), (32,))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jg = jnp.asarray(g, getattr(jnp, dtype))
    want = jcommon.rms_norm(jx, jg, 1e-6)
    got = common.rms_norm(t(x).to(getattr(torch, dtype)),
                          t(g).to(getattr(torch, dtype)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(got, want)
    else:
        # the same f32 normalisation, rounded to bf16 before and after the
        # gamma multiply in both: at most one bf16 ulp (2^-8 relative) apart
        np.testing.assert_allclose(np.asarray(got.float()),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    (x,) = arrays(2, (2, 9, 3, 16))
    pos = np.arange(9, dtype=np.int32) + 5
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(t(x), t(pos), theta)
    # angles up to 13 rad: 1 f32 ulp of an angle is ~1e-6
    close(got, want, atol=1e-5)


def test_swiglu():
    x, wg, wu, wd = arrays(3, (2, 4, 32), (32, 48), (32, 48), (48, 32),
                           scale=0.3)
    want = jcommon.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    got = common.swiglu(*(t(a) for a in (x, wg, wu, wd)))
    close(got, want)


@pytest.mark.parametrize("vocab", [256, 250])
def test_lm_head_logits(vocab):
    v_pad = jcommon.padded_vocab(vocab)
    assert common.padded_vocab(vocab) == v_pad
    x, head = arrays(4, (2, 3, 32), (32, v_pad), scale=0.5)
    want = jcommon.lm_head_logits(jnp.asarray(x), jnp.asarray(head), vocab)
    got = common.lm_head_logits(t(x), t(head), vocab)
    assert got.shape == (2, 3, v_pad)
    if v_pad != vocab:
        assert bool((got[..., vocab:] == -1e30).all())
    close(got, want)


def gqa_params(seed, D=32, H=4, Hkv=2, Dh=16):
    wq, wk, wv, wo = arrays(seed, (D, H, Dh), (D, Hkv, Dh), (D, Hkv, Dh),
                            (H, Dh, D), scale=D ** -0.5)
    return ({k: jnp.asarray(a) for k, a in zip(("wq", "wk", "wv", "wo"),
                                               (wq, wk, wv, wo))},
            {k: t(a) for k, a in zip(("wq", "wk", "wv", "wo"),
                                     (wq, wk, wv, wo))})


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_apply_gqa_no_cache(impl):
    jp, tp = gqa_params(5, Dh=64)
    (x,) = arrays(6, (2, 64, 32))
    pos = np.arange(64, dtype=np.int32)
    want, _ = jattn.apply_gqa(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                              rope_theta=500000.0, impl=impl)
    got, cache = attention.apply_gqa(tp, t(x), positions=t(pos),
                                     rope_theta=500000.0, impl=impl)
    assert cache is None
    close(got, want)


def test_apply_gqa_prefill_then_decode():
    """Prefill into a cache at 0, then one decode step at S: the output and
    the cache equal the reference's."""
    B, S, Smax, D, Hkv, Dh = 2, 7, 12, 32, 2, 16
    jp, tp = gqa_params(7)
    x, x1 = arrays(8, (B, S, D), (B, 1, D))
    jc = (jnp.zeros((B, Smax, Hkv, Dh)), jnp.zeros((B, Smax, Hkv, Dh)))
    tc = (torch.zeros(B, Smax, Hkv, Dh), torch.zeros(B, Smax, Hkv, Dh))
    pos = np.arange(S, dtype=np.int32)
    want, jc = jattn.apply_gqa(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                               cache=jc, cache_pos=jnp.int32(0))
    got, tc = attention.apply_gqa(tp, t(x), positions=t(pos), cache=tc,
                                  cache_pos=0)
    close(got, want)
    for a, b in zip(tc, jc):
        close(a, b)
    want, jc = jattn.apply_gqa(jp, jnp.asarray(x1),
                               positions=jnp.asarray([S], jnp.int32),
                               cache=jc, cache_pos=jnp.int32(S))
    got, tc = attention.apply_gqa(tp, t(x1), positions=torch.tensor([S]),
                                  cache=tc, cache_pos=S)
    close(got, want)
    for a, b in zip(tc, jc):
        close(a, b)


def test_sdpa_q_chunks_match_one_block():
    """Sq > 2048 is cut into q chunks; the result does not depend on it."""
    q, k, v = arrays(9, (1, 64, 2, 8), (1, 64, 1, 8), (1, 64, 1, 8))
    whole = attention.sdpa(t(q), t(k), t(v), causal=True, q_chunk=0)
    chunked = attention.sdpa(t(q), t(k), t(v), causal=True, q_chunk=16)
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, q_chunk=16)
    close(chunked, want)
    close(whole, np.asarray(chunked))
