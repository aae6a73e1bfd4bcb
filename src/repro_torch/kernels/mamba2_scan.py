"""Mamba-2 SSD chunked scan (mirrors :mod:`repro.kernels.mamba2_scan`).

``mamba2_scan`` runs the SSD scan from a zero state over a full sequence:
every Mamba layer of the hybrid model's full-sequence forward under
``ModelConfig.ssm_impl="mamba_kernel"``. On a CUDA tensor it launches the
hand-written kernel ``csrc/mamba2_scan.cu`` (built by
:mod:`repro_torch.kernels._build` at first use), which takes f32 or bf16
inputs, head dims and state sizes that are multiples of 4 up to 64, and
chunks that are multiples of 4 up to 128. The source holds two kernels and
:func:`kernel_route` picks one from the type and the shapes alone: bf16 at
chunks of 64 or 128 with P and N multiples of 16 (every Mamba layer of the
hybrid forward) runs on the tensor cores, every other input on the CUDA
cores. On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.mamba2_scan_ref`. There is no fallback
between any of them: a CUDA tensor launches its route's kernel or raises.

The reference's kernel has no gradient (``jax.grad`` through it raises), so
neither has this one: in grad mode, tensors that require grad are refused
on either device with a ``RuntimeError`` that names the plain route,
``ssm_impl="xla"`` (``ssd_chunked``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba2_scan_ref

_SIGNATURES = {
    "mamba2_scan_launch":
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "mamba2_scan_tc_launch":
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = MAX_STATE = 64
MAX_CHUNK = 128
TC_CHUNKS = (64, 128)
_MAX_BLOCKS = 2 ** 31 - 1


def kernel_route(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel a CUDA input of this type and these shapes launches:
    ``"tensor_cores"`` (wgmma, TMA) for bf16 at a chunk in ``TC_CHUNKS``
    with P and N multiples of 16 up to 64, else ``"cuda_cores"`` (f32,
    which TF32 cannot hold to the gate, and small or odd shapes)."""
    if (dtype == torch.bfloat16 and chunk in TC_CHUNKS and P % 16 == 0
            and N % 16 == 0 and P <= MAX_HEAD_DIM and N <= MAX_STATE):
        return "tensor_cores"
    return "cuda_cores"


def kernel_takes(dtype: torch.dtype, S: int, P: int, N: int,
                 chunk: int) -> bool:
    """Whether the kernel takes inputs of ``dtype`` over ``S`` steps at head
    dim ``P``, state size ``N`` and the scan chunk ``chunk`` (used as
    ``min(chunk, S)``, which must divide S): what a CUDA call accepts, the
    layout and alignment aside. A caller that can choose between the kernel
    and the plain scan asks here."""
    c = min(chunk, S)
    return (dtype in KERNEL_DTYPES and c >= 1 and S % c == 0
            and c % 4 == 0 and c <= MAX_CHUNK and P % 4 == 0
            and P <= MAX_HEAD_DIM and N % 4 == 0 and N <= MAX_STATE)


def _check(x, dt, A, Bm, Cm, chunk) -> int:
    """Validates shapes, types and devices; returns the chunk the scan uses
    (``min(chunk, S)``, as the reference)."""
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [B, S, H, P] tensor, got "
                         f"shape {tuple(x.shape)}")
    B, S, H, P = x.shape
    if dt.shape != (B, S, H):
        raise ValueError(f"dt must be [B={B}, S={S}, H={H}], got shape "
                         f"{tuple(dt.shape)}")
    if A.shape != (H,):
        raise ValueError(f"A must be [H={H}], got shape {tuple(A.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Bm.shape[2] < 1:
        raise ValueError(f"Bm must be [B={B}, S={S}, N], got shape "
                         f"{tuple(Bm.shape)}")
    if Cm.shape != Bm.shape:
        raise ValueError(f"Cm shape {tuple(Cm.shape)} != Bm shape "
                         f"{tuple(Bm.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    _build.refuse_grad("mamba2_scan", 'ssm_impl="xla"', x=x, dt=dt, A=A,
                       Bm=Bm, Cm=Cm)
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of the chunk {chunk}")
    return chunk


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128):
    """``x [B, S, H, P]``, ``dt [B, S, H]`` (> 0), ``A [H]`` (< 0),
    ``Bm``/``Cm [B, S, N]`` -> ``(y [B, S, H, P], h_last [B, H, P, N])``,
    both f32, from a zero state; S must be a multiple of ``min(chunk, S)``.
    ``mamba2_scan.launches`` counts the kernel's launches, and
    ``mamba2_scan.route_launches`` the launches of each route."""
    chunk = _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return mamba2_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    B, S, H, P = x.shape
    N = Bm.shape[2]
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernel takes {KERNEL_DTYPES}, got {x.dtype}")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    if not kernel_takes(x.dtype, S, P, N, chunk):
        raise ValueError(
            f"the kernel takes P and N that are multiples of 4 up to "
            f"{MAX_HEAD_DIM} and chunks that are multiples of 4 up to "
            f"{MAX_CHUNK}, got P={P}, N={N}, chunk={chunk}")
    if B * H > _MAX_BLOCKS or B * S > _MAX_BLOCKS:
        raise ValueError(f"the kernel takes at most {_MAX_BLOCKS} (batch, "
                         f"head) pairs and rows, got {B * H} and {B * S}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load("mamba2_scan", _SIGNATURES)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    route = kernel_route(x.dtype, P, N, chunk)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h_last.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tensor_cores":
            err = lib.mamba2_scan_tc_launch(*ptrs, B, S, H, P, N, chunk,
                                            stream)
        else:
            err = lib.mamba2_scan_launch(*ptrs, B, S, H, P, N, chunk,
                                         int(x.dtype == torch.bfloat16),
                                         stream)
    if err != 0:
        raise RuntimeError(f"mamba2_scan: kernel launch ({route}) failed "
                           f"with CUDA error {err}")
    mamba2_scan.launches += 1
    mamba2_scan.route_launches[route] += 1
    return y, h_last


mamba2_scan.launches = 0
mamba2_scan.route_launches = {"tensor_cores": 0, "cuda_cores": 0}
