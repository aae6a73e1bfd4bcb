"""Flash attention (mirrors :mod:`repro.kernels.flash_attention`).

``flash_attention`` is causal or non-causal grouped-query attention with an
online softmax in f32: the prefill attention of every GQA layer under
``ModelConfig.attn_impl="flash"``. On a CUDA tensor it launches the
hand-written kernels of ``csrc/flash_attention.cu`` (built by
:mod:`repro_torch.kernels._build` at first use), chosen by dtype: bf16 runs
on the tensor cores (wgmma, K and V fed by TMA), f32 on the CUDA cores (the
tensor cores' only f32 path, TF32, cannot meet the f32 tolerance). Both
take head dims 64 and 128 and any ``H % Hkv == 0``, and read the
``[B, S, H, D]`` layout in place. On a CPU tensor it runs the plain
version, :func:`repro_torch.kernels.ref.flash_attention_ref`. There is no
fallback between the two: a CUDA tensor launches a kernel or raises.
The kernels have no backward, as the reference's has none: on a CUDA
tensor that requires grad (in grad mode) the wrapper raises and names the
plain route, ``attn_impl="xla"``. The plain version on the CPU stays
differentiable.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_SIGNATURES = {"flash_attention_launch":
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_void_p]}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def _check(q, k, v) -> None:
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q must be a non-empty [B, S, H, D] tensor, got "
                         f"shape {tuple(q.shape)}")
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"k must be [B={B}, S={S}, Hkv, D={D}], got shape "
                         f"{tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape "
                         f"{tuple(k.shape)}")
    if k.shape[2] < 1 or H % k.shape[2] != 0:
        raise ValueError(f"H={H} must be a multiple of Hkv={k.shape[2]}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``q [B, S, H, D]``, ``k``/``v [B, S, Hkv, D]`` -> ``[B, S, H, D]`` in
    q's dtype. ``flash_attention.launches`` counts the kernel's launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _build.refuse_grad("flash_attention", 'attn_impl="xla"', q=q, k=k, v=v)
    B, S, H, D = q.shape
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if H > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_YZ} heads and "
                         f"batch rows, got H={H}, B={B}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[2], D, int(q.dtype == torch.bfloat16), int(causal),
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
