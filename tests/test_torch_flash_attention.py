"""The port's flash attention against the reference's.

Inputs are made with numpy from a seed and handed to both packages. On CPU
tensors the port's ``flash_attention`` runs its plain version; it must
agree with the reference's Pallas kernel (interpret mode on the CPU) on
``tests/test_kernels.py``'s shapes, f32 and bf16, causal and not, to that
file's tolerances: 1e-5 in f32 (one summation order against another), 2e-2
in bf16 (both round the same f32 result to bf16, one ulp at |o| ~ 2 is
2^-7). The ragged lengths the kernel takes and the Pallas kernel does not
are held against the reference's oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are small: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_qkv(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def both(arrays, dtype):
    """The same (rounded) inputs for the reference and for the port."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def as_f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("S,H,Hkv,D", [
    (128, 4, 4, 64), (256, 4, 2, 64), (256, 8, 1, 128), (512, 2, 2, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_kernel(S, H, Hkv, D, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(S + H + D, 2, S, H, Hkv, D),
                                      dtype)
    want = ops.flash_attention(jq, jk, jv, causal=causal)
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 1, 4, 4, 64), (2, 200, 4, 2, 64), (1, 130, 8, 1, 128),
    (2, 12, 4, 2, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracle(B, S, H, Hkv, D, causal):
    """Ragged and tiny lengths, and the smoke config's head dim 16."""
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(S * 7 + D, B, S, H, Hkv, D),
                                      "float32")
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-5)


def test_wrapper_checks_and_counts_no_cpu_launch():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(0, 1, 8, 4, 2, 64))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before   # CPU: the plain version
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :3], k, v)      # H % Hkv != 0
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v.double())


def test_public_wrapper_matches_pallas_kernel_and_takes_no_tiles():
    """``repro_torch.kernels.ops.flash_attention`` against the reference's
    public wrapper (interpret mode); the port's kernel picks its own tiles,
    so a tile argument is refused rather than ignored."""
    from repro_torch.kernels import ops as tops
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(3, 1, 128, 4, 2, 64),
                                      "float32")
    want = ops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                               block_k=64)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=TOL["float32"])
    with pytest.raises(TypeError):
        tops.flash_attention(tq, tk, tv, block_q=64)
