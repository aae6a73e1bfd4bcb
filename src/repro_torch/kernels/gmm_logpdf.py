"""GMM component log densities, the EM E-step (mirrors
:mod:`repro.kernels.gmm_logpdf`).

``gmm_logpdf`` computes ``out[n, k] = log w_k + log N(x_n | mu_k, Sigma_k)``
for every observation against every component, from the inverse lower
Cholesky factors. On a CUDA tensor it launches the hand-written kernel
``csrc/gmm_logpdf.cu`` (built by :mod:`repro_torch.kernels._build` at first
use), which takes K <= 64 components in D <= 128 dimensions, as the
reference states; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.gmm_logpdf_ref`. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gmm_logpdf_ref

_SIGNATURES = {"gmm_logpdf_launch":
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
MAX_COMPONENTS = 64
MAX_DIM = 128
_MAX_ROWS = 2 ** 31 - 128     # the launcher's int row count and grid


def _check(x, means, inv_chol, log_w) -> None:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [N, D] tensor, got shape "
                         f"{tuple(x.shape)}")
    D = x.shape[1]
    if means.dim() != 2 or means.shape[0] < 1 or means.shape[1] != D:
        raise ValueError(f"means must be [K, D={D}], got shape "
                         f"{tuple(means.shape)}")
    K = means.shape[0]
    for name, t, shape in (("inv_chol", inv_chol, (K, D, D)),
                           ("log_w", log_w, (K,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got shape "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("means", means), ("inv_chol", inv_chol),
                    ("log_w", log_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gmm_logpdf(x: torch.Tensor, means: torch.Tensor, inv_chol: torch.Tensor,
               log_w: torch.Tensor) -> torch.Tensor:
    """``x [N, D]``, ``means [K, D]``, ``inv_chol [K, D, D]`` (inverse
    lower Cholesky factors), ``log_w [K]``, all f32 on one device ->
    ``[N, K]`` f32 log densities plus log weights.
    ``gmm_logpdf.launches`` counts the kernel's launches."""
    _check(x, means, inv_chol, log_w)
    if x.device.type == "cpu":
        return gmm_logpdf_ref(x, means, inv_chol, log_w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm_logpdf runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _build.refuse_grad("gmm_logpdf", "kernels.ref.gmm_logpdf_ref", x=x,
                       means=means, inv_chol=inv_chol, log_w=log_w)
    N, D = x.shape
    K = means.shape[0]
    if K > MAX_COMPONENTS or D > MAX_DIM:
        raise ValueError(f"the kernel takes K <= {MAX_COMPONENTS} and "
                         f"D <= {MAX_DIM}, got K={K}, D={D}")
    if N >= _MAX_ROWS:
        raise ValueError(f"the kernel takes fewer than {_MAX_ROWS} rows, "
                         f"got {N}")
    for name, t in (("x", x), ("means", means), ("inv_chol", inv_chol),
                    ("log_w", log_w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _build.load("gmm_logpdf", _SIGNATURES)
    out = torch.empty((N, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gmm_logpdf_launch(
            x.data_ptr(), means.data_ptr(), inv_chol.data_ptr(),
            log_w.data_ptr(), out.data_ptr(), N, D, K,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm_logpdf: kernel launch failed with CUDA "
                           f"error {err}")
    gmm_logpdf.launches += 1
    return out


gmm_logpdf.launches = 0
