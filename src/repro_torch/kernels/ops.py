"""Public wrappers of the kernels (mirrors :mod:`repro.kernels.ops`).

The reference's wrappers pick Pallas's interpret mode off the TPU; here the
device of the inputs takes the place of ``interpret=``: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor runs its plain
version. The port's kernels choose their own tiles, so the reference's tile
arguments (``block_q``, ``block_k``, ``block_n``) are not taken. The models
call the kernel modules directly; this module is the entry point for a
caller who wants one kernel on its own, as ``queue_scan``'s capacity sweep
does.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.gmm_logpdf import gmm_logpdf as _gmm
from repro_torch.kernels.mamba2_scan import mamba2_scan as _mamba
from repro_torch.kernels.queue_scan import fused_admission  # noqa: F401  (re-export)
from repro_torch.kernels.queue_scan import queue_scan as _queue


def flash_attention(q, k, v, *, causal: bool = True):
    return _flash(q, k, v, causal=causal)


def mamba2_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    return _mamba(x, dt, A, Bm, Cm, chunk=chunk)


def queue_scan(ready, service, *, capacity: int):
    return _queue(ready, service, capacity=capacity)


def gmm_logpdf(x, means, inv_chol, log_w):
    return _gmm(x, means, inv_chol, log_w)
