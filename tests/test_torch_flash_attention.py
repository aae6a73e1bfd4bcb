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
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _tool(name):
    """A script of ``tools/`` as a module."""
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the seeded inputs and the bf16 kernel's emulation, shared with
# tools/flash_row_error.py, which reads the kernel on the same rows
_rows = _tool("flash_row_error")
make_qkv = _rows.make_qkv
emulate_bf16_kernel = _rows.emulate_bf16_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are small: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 1, 4, 4, 64), (4, 64, 4, 2, 128), (1, 128, 8, 1, 64),
    (1, 200, 32, 8, 64), (1, 200, 4, 4, 128), (4, 256, 4, 2, 64),
    (1, 1024, 32, 8, 64), (1, 1024, 4, 4, 128), (1, 2048, 8, 1, 64),
    (1, 2048, 4, 2, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_arithmetic_within_gate(B, S, H, Hkv, D, causal):
    """A check of the emulation only, not of the kernel: it runs no code
    of the port but ``flash_attention_ref``, and passes whatever the CUDA
    kernel does (the card-only tests in ``test_torch_cuda.py`` and
    ``chip_smoke.py`` phase 5 check the kernel). It pins the error budget
    the kernel's design rests on, at the card grid's shapes (B and heads
    cut where the CPU would take long): bf16 inputs, f32 scores, P as bf16
    hi + lo, f32 accumulation and one rounding to bf16 stay within the
    2e-2 gate of the plain version on randn inputs."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in make_qkv(S + H + D, B, S, H, Hkv, D))
    want = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    got = emulate_bf16_kernel(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]


def test_smoke_row_check_sees_late_rows():
    """``chip_smoke.py``'s bf16 check on each output row's ||diff|| /
    ||want|| passes the emulated kernel and catches a 3 % error in the
    last eighth of the causal rows, where |o| is small enough that the
    2e-2 gate on the largest difference alone lets it through."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    S = 1024
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in make_qkv(7, 1, S, 8, 2, 64))
    want = ref.flash_attention_ref(tq, tk, tv, causal=True)
    got = emulate_bf16_kernel(tq, tk, tv, True)
    err, rel = smoke.flash_errs(got, want, "on the emulated kernel")
    assert err <= smoke.FLASH_TOL["bfloat16"]
    assert rel <= smoke.FLASH_ROW_REL_TOL
    bad = got.float()
    bad[:, S - S // 8:] *= 1.03
    bad = bad.bfloat16()
    assert (float((bad.float() - want.float()).abs().max())
            <= smoke.FLASH_TOL["bfloat16"])
    with pytest.raises(AssertionError, match="row-relative"):
        smoke.flash_errs(bad, want, "on a late-row fault")


def row_rel(got, want):
    """The largest ||got - want|| / ||want|| over the output's rows."""
    diff = got.float() - want.float()
    return float((diff.norm(dim=-1) / want.float().norm(dim=-1)).max())


@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 1024, 32, 8, 64),
                                         (1, 2048, 32, 32, 64),
                                         (4, 1024, 4, 2, 128)])
def test_bf16_fma_fold_and_row_error(B, S, H, Hkv, D, capsys):
    """The kernel's FMA fold of the softmax scale against the two-rounding
    exponent the emulation used before: both within the 1e-2 row-relative
    gate, and the two differ by far less than the largest row error
    itself (printed with ``-s``: the fold is not what sets the card's row
    error). An emulation check only, as the test above."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in make_qkv(S + H + D + 1, B, S, H, Hkv, D))
    want = ref.flash_attention_ref(tq, tk, tv, causal=True)
    folded = emulate_bf16_kernel(tq, tk, tv, True)
    unfolded = emulate_bf16_kernel(tq, tk, tv, True, fold=False)
    rel_f, rel_u = row_rel(folded, want), row_rel(unfolded, want)
    moved = float((folded.float() - unfolded.float()).abs().max())
    with capsys.disabled():
        print(f"\nflash bf16 emulation {(B, S, H, Hkv, D)} causal: largest "
              f"row-relative error {rel_f:.5f} with the FMA fold, "
              f"{rel_u:.5f} without; largest output change {moved:.3g}")
    assert rel_f <= 1e-2 and rel_u <= 1e-2
    assert abs(rel_f - rel_u) <= 0.25 * rel_u
