"""The arithmetic of the SSD scan's tensor-core kernel, emulated on the CPU.

``csrc/mamba2_scan.cu``'s bf16 route (``mamba2_tc_kernel``) cannot run
here, so :func:`emulate_tc_kernel` repeats its arithmetic in PyTorch: the
warp-scan ``cum`` of ``dt A`` rounded products, C Bᵀ of the exact bf16
inputs summed in f32 one k16 step after another, M = S exp(cum_i - cum_j)
dt_j masked to j <= i, the readout C stateᵀ from the state's bf16 terms
scaled by exp(cum_i), M x from M's bf16 terms, and the register-carried f32
state updated as exp(cum_last) state + xᵀ(B w) from B w's bf16 terms. Each
f32 operand of a product (M, the state, B w) is split into ``terms`` bf16
values, hi = bf16(v), lo = bf16(v - hi); the kernel uses two.

Inputs are made with numpy from a seed at the reference kernel test's scales
and rounded to bf16 (the hybrid forward's type); the plain version and the
reference's Pallas kernel (interpret mode) take the same rounded values in
f32. The gate is ``chip_smoke.py``'s for the kernel on the card: 2e-4 +
1e-4 |y| (``tests/test_kernels.py``'s atol plus a relative part for the
summation order at large |y|). What this file checks is the emulation, not
the kernel: ``chip_smoke.py`` phase 9 and ``tests/test_torch_cuda.py`` hold
the kernel itself against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import ref

ATOL, RTOL = 2e-4, 1e-4      # chip_smoke.py's SSD_ATOL, SSD_RTOL


@pytest.fixture(autouse=True, scope="module")
def _few_cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def split(a, terms):
    """``a`` as ``terms`` bf16 values (as f32) whose sum approximates it:
    each the bf16 rounding of what the ones before leave."""
    out = []
    for _ in range(terms):
        t = a.bfloat16().float()
        out.append(t)
        a = a - t
    return out


def warp_scan_cumsum(dA):
    """The kernel's ``cum`` over the last axis (Q = 32 runs of Q / 32
    steps): each lane sums its run, a Hillis-Steele shuffle scan over the
    32 run sums, then each lane adds its steps to the sum of the runs
    before it, one f32 add at a time."""
    Q = dA.shape[-1]
    per = Q // 32
    runs = [dA[..., l * per:(l + 1) * per] for l in range(32)]
    incl = []
    for r in runs:
        s = torch.zeros(dA.shape[:-1])
        for k in range(per):
            s = s + r[..., k]
        incl.append(s)
    off = 1
    while off < 32:
        incl = [incl[l] + incl[l - off] if l >= off else incl[l]
                for l in range(32)]
        off *= 2
    cum = torch.empty_like(dA)
    for l in range(32):
        acc = incl[l - 1] if l else torch.zeros(dA.shape[:-1])
        for k in range(per):
            acc = acc + runs[l][..., k]
            cum[..., l * per + k] = acc
    return cum


def emulate_tc_kernel(x, dt, A, Bm, Cm, chunk, terms=2):
    """``(y [B, S, H, P], h_last [B, H, P, N])`` f32, as the tensor-core
    kernel computes them (module docstring)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    Q = chunk
    x, dt, Bm, Cm = (a.float() for a in (x, dt, Bm, Cm))
    y = torch.empty(Bsz, S, H, P)
    st = torch.zeros(Bsz, H, P, N)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()          # j <= i
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc = x[:, sl].permute(0, 2, 1, 3)                      # [B, H, Q, P]
        dtc = dt[:, sl].permute(0, 2, 1)                       # [B, H, Q]
        Bc, Cc = Bm[:, sl, None].transpose(1, 2), Cm[:, sl, None].transpose(1, 2)
        cum = warp_scan_cumsum(dtc * A[None, :, None])
        last = cum[..., -1:]
        w = torch.exp(last - cum) * dtc
        s = torch.zeros(Bsz, 1, Q, Q)
        for k in range(0, N, 16):
            s = s + Cc[..., k:k + 16] @ Bc[..., k:k + 16].transpose(-1, -2)
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
        M = torch.where(tri, s * torch.exp(diff) * dtc[..., None, :], 0.0)
        ya = torch.zeros(Bsz, H, Q, P)
        if c:
            sts = split(st, terms)
            for k in range(0, N, 16):
                for t in sts:
                    ya = ya + Cc[..., k:k + 16] @ t[..., k:k + 16].transpose(-1, -2)
        ya = ya * torch.exp(cum)[..., None]
        ms_ = split(M, terms)
        bws = split(Bc * w[..., None], terms)
        st = st * torch.exp(last)[..., None]
        for k in range(0, Q, 16):
            for t in ms_:
                ya = ya + t[..., k:k + 16] @ xc[..., k:k + 16, :]
            for t in bws:
                st = st + xc[..., k:k + 16, :].transpose(-1, -2) @ t[..., k:k + 16, :]
        y[:, sl] = ya.permute(0, 2, 1, 3)
    return y, st


def ssd_inputs(seed, B, S, H, P, N):
    """numpy draws at the reference test's scales; x, dt, B, C rounded to
    bf16, A f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    softplus = lambda a: np.log1p(np.exp(-np.abs(a))) + np.maximum(a, 0.0)
    arrs = (f(B, S, H, P) * 0.5, (softplus(f(B, S, H)) * 0.1).astype(np.float32),
            -np.exp(f(H) * 0.3).astype(np.float32), f(B, S, N) * 0.3,
            f(B, S, N) * 0.3)
    return [torch.from_numpy(a) if i == 2 else torch.from_numpy(a).bfloat16()
            for i, a in enumerate(arrs)]


def gate_ratio(got, want):
    """The largest |got - want| / (ATOL + RTOL |want|) over y and h_last:
    at most 1 inside the gate."""
    worst = 0.0
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        worst = max(worst, float(((g - w).abs()
                                  / (ATOL + RTOL * w.abs())).max()))
    return worst


# (B, S, H, P, N, chunk): shapes of chip_smoke.py's grid that run in
# seconds here, and S = 4,096 at H = 4, where |y| is largest
SHAPES = [(1, 128, 4, 32, 32, 64), (2, 128, 1, 64, 64, 128),
          (1, 192, 4, 64, 32, 64), (2, 256, 4, 32, 64, 128),
          (1, 1024, 4, 64, 64, 128), (1, 4096, 4, 64, 64, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_tc_arithmetic_within_gate(B, S, H, P, N, chunk):
    """hi + lo terms: within the gate of the plain version (seen: at most
    1.5 % of it)."""
    args = ssd_inputs(S + H + P, B, S, H, P, N)
    want = ref.mamba2_scan_ref(*args, chunk=chunk)
    assert gate_ratio(emulate_tc_kernel(*args, chunk), want) <= 1.0


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 128, 2, 32, 32, 64),
                                              (1, 256, 4, 64, 64, 128)])
def test_tc_arithmetic_matches_reference_kernel(B, S, H, P, N, chunk):
    """The reference's Pallas kernel in interpret mode, on the same
    bf16-rounded values: within the same gate."""
    args = ssd_inputs(S + N, B, S, H, P, N)
    want = jops.mamba2_scan(*(jnp.asarray(a.float().numpy()) for a in args),
                            chunk=chunk, interpret=True)
    assert gate_ratio(emulate_tc_kernel(*args, chunk), want) <= 1.0


def test_one_bf16_term_breaks_the_gate():
    """Why the split: with M, the state and B w each rounded once to bf16
    (2^-9 relative) the S = 4,096 case misses the gate several times over,
    where hi + lo holds it with room to spare."""
    args = ssd_inputs(7, 1, 4096, 4, 64, 64)
    want = ref.mamba2_scan_ref(*args, chunk=128)
    assert gate_ratio(emulate_tc_kernel(*args, 128, terms=1), want) > 2.0
    assert gate_ratio(emulate_tc_kernel(*args, 128, terms=2), want) < 0.1


@pytest.mark.parametrize("dtype,P,N,chunk,route", [
    (torch.bfloat16, 64, 64, 128, "tensor_cores"),
    (torch.bfloat16, 32, 64, 64, "tensor_cores"),
    (torch.bfloat16, 16, 48, 128, "tensor_cores"),
    (torch.float32, 64, 64, 128, "cuda_cores"),
    (torch.bfloat16, 64, 64, 32, "cuda_cores"),
    (torch.bfloat16, 16, 16, 8, "cuda_cores"),
    (torch.bfloat16, 8, 4, 128, "cuda_cores"),
    (torch.bfloat16, 36, 64, 128, "cuda_cores")])
def test_kernel_route(dtype, P, N, chunk, route):
    """The route is a function of the type and the shapes alone: the
    hybrid's bf16 P = N = 64 at chunk 128 and the grid's bf16 shapes take
    the tensor cores; f32, chunks other than 64 and 128, and P or N not a
    multiple of 16 take the CUDA cores."""
    assert ms.kernel_route(dtype, P, N, chunk) == route


@pytest.mark.parametrize("dtype,S,P,N,chunk,takes", [
    (torch.bfloat16, 512, 64, 64, 128, True),
    (torch.float32, 8, 16, 16, 128, True),
    (torch.bfloat16, 16, 16, 16, 8, True),
    (torch.bfloat16, 6, 64, 64, 128, False),
    (torch.bfloat16, 10, 64, 64, 128, False),
    (torch.bfloat16, 13, 16, 16, 8, False),
    (torch.bfloat16, 512, 64, 64, 256, False),
    (torch.bfloat16, 512, 80, 64, 128, False),
    (torch.bfloat16, 512, 64, 68, 128, False),
    (torch.float16, 512, 64, 64, 128, False)])
def test_kernel_takes(dtype, S, P, N, chunk, takes):
    """The shapes and types the CUDA kernel accepts: a chunk of
    ``min(chunk, S)`` that divides S, is a multiple of 4 and at most 128,
    P and N multiples of 4 up to 64, f32 or bf16. A prompt shorter than
    the chunk is its own chunk, so 6 or 10 tokens are refused and 8
    taken."""
    assert ms.kernel_takes(dtype, S, P, N, chunk) is takes
