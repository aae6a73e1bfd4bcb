"""The queue kernels (mirrors :mod:`repro.kernels.queue_scan`).

``queue_scan`` is a batch of independent c-server FIFO stations, one per
row: each job, in ready order, takes the earliest free of ``capacity``
slots (a Monte-Carlo capacity sweep of thousands of stations in one call;
public as :func:`repro_torch.kernels.ops.queue_scan`). On a CUDA tensor it
launches the hand-written kernel ``csrc/queue_scan.cu``, which keeps each
station's slots sorted over G lanes of S slots each, the route ``(S, G)``
that :func:`kernel_route` names; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.queue_scan_ref`. Both are exact, and equal
bit for bit.

``fused_admission`` is one ranked admission round of
``vdes._admission_stage``: for each queued job, its seat under the stable
lexicographic ``(resource, policy key, enqueue wave, id)`` ranking, tested
against the free slots of its resource. On a CUDA tensor it launches the
hand-written kernel ``csrc/fused_admission.cu``; on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.admission_mask_dense`.

Both kernels are built by :mod:`repro_torch.kernels._build` at first use.
There is no fallback between a kernel and its plain version: a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import admission_mask_dense, queue_scan_ref

_SIGNATURES = {"fused_admission_launch":
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
_QUEUE_SIGNATURES = {
    "queue_scan_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "queue_scan_launch_route": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "queue_scan_route": [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2}
_MAX_GRID_Y = 65535
MAX_CAPACITY = 256          # slots the queue kernel holds in registers
# the kernel's routes (S slots per lane, G lanes per station), as
# csrc/queue_scan.cu instantiates them
ROUTES = ((1, 1), (8, 1), (8, 2), (8, 4), (8, 8), (16, 8), (16, 16))


def kernel_route(capacity: int) -> tuple:
    """The route ``(S, G)`` the kernel takes at this capacity (1 to
    ``MAX_CAPACITY``), as its library reports it (``csrc/queue_scan.cu::
    route_for``); builds the library at first use."""
    if not 1 <= capacity <= MAX_CAPACITY:
        raise ValueError(f"the kernel takes 1 <= capacity <= {MAX_CAPACITY},"
                         f" got {capacity}")
    lib = _build.load("queue_scan", _QUEUE_SIGNATURES)
    S, G = ctypes.c_int(), ctypes.c_int()
    if lib.queue_scan_route(capacity, ctypes.byref(S), ctypes.byref(G)):
        raise RuntimeError(f"queue_scan_route refused capacity {capacity}")
    return S.value, G.value


def queue_scan(ready: torch.Tensor, service: torch.Tensor, *,
               capacity: int):
    """``ready``, ``service [R, N]`` (each row sorted by ready time) ->
    ``(start, finish) [R, N]`` f32: exact M/G/c FIFO station times, one
    station per row (oracle: :func:`repro_torch.core.des.
    single_station_fifo` per row). Float inputs are cast to f32, as the
    reference does. ``queue_scan.launches`` counts the kernel's launches."""
    if ready.dim() != 2 or min(ready.shape) < 1:
        raise ValueError(f"ready must be a non-empty [R, N] tensor, got "
                         f"shape {tuple(ready.shape)}")
    if service.shape != ready.shape:
        raise ValueError(f"service shape {tuple(service.shape)} != ready "
                         f"shape {tuple(ready.shape)}")
    if service.device != ready.device:
        raise ValueError(f"service is on {service.device}, ready on "
                         f"{ready.device}")
    for name, t in (("ready", ready), ("service", service)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    if int(capacity) != capacity or capacity < 1:
        raise ValueError(f"capacity must be an integer >= 1, got {capacity}")
    capacity = int(capacity)
    if ready.device.type == "cpu":
        return queue_scan_ref(ready, service, capacity=capacity)
    if ready.device.type != "cuda":
        raise ValueError(f"queue_scan runs on cuda or cpu tensors, got "
                         f"{ready.device}")
    _build.refuse_grad("queue_scan", "kernels.ref.queue_scan_ref",
                       ready=ready, service=service)
    R, N = ready.shape
    if capacity > MAX_CAPACITY:
        raise ValueError(f"the kernel takes capacity <= {MAX_CAPACITY}, got "
                         f"{capacity}")
    ready = ready.float().contiguous()
    service = service.float().contiguous()
    lib = _build.load("queue_scan", _QUEUE_SIGNATURES)
    start = torch.empty_like(ready)
    finish = torch.empty_like(ready)
    with torch.cuda.device(ready.device):
        err = lib.queue_scan_launch(
            ready.data_ptr(), service.data_ptr(), start.data_ptr(),
            finish.data_ptr(), R, N, capacity,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"queue_scan: kernel launch failed with CUDA "
                           f"error {err}")
    queue_scan.launches += 1
    return start, finish


queue_scan.launches = 0


def _check(res_q, pkey, enq_wave, free) -> None:
    if res_q.dim() != 2 or res_q.shape[0] < 1 or res_q.shape[1] < 1:
        raise ValueError(f"res_q must be a non-empty [R, N] tensor, got "
                         f"shape {tuple(res_q.shape)}")
    R = res_q.shape[0]
    for name, t, dt, shape in (
            ("res_q", res_q, torch.int32, res_q.shape),
            ("pkey", pkey, torch.float32, res_q.shape),
            ("enq_wave", enq_wave, torch.int32, res_q.shape),
            ("free", free, torch.int32, None)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if t.device != res_q.device:
            raise ValueError(f"{name} is on {t.device}, res_q on "
                             f"{res_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if free.dim() != 2 or free.shape[0] != R or free.shape[1] < 1:
        raise ValueError(f"free must be [R={R}, nres >= 1], got shape "
                         f"{tuple(free.shape)}")


def fused_admission(res_q: torch.Tensor, pkey: torch.Tensor,
                    enq_wave: torch.Tensor,
                    free: torch.Tensor) -> torch.Tensor:
    """The wave loop's admission round: ``[R, N]`` bool admitted mask.

    ``res_q [R, N]`` i32 — each job's resource, with the ``nres`` sentinel
    for non-queued rows; ``pkey [R, N]`` f32 — the policy key;
    ``enq_wave [R, N]`` i32 — FIFO tie-break wave counter; ``free
    [R, nres]`` i32 — free slots per resource. All contiguous, on one
    device. Bit-identical to the sorted ranking of the reference engine.
    ``fused_admission.launches`` counts the kernel's launches."""
    _check(res_q, pkey, enq_wave, free)
    if res_q.device.type == "cpu":
        return admission_mask_dense(res_q, pkey, enq_wave, free)
    if res_q.device.type != "cuda":
        raise ValueError(f"fused_admission runs on cuda or cpu tensors, "
                         f"got {res_q.device}")
    _build.refuse_grad("fused_admission", "kernels.ref.admission_mask_dense",
                       pkey=pkey)
    R, N = res_q.shape
    if R > _MAX_GRID_Y:
        raise ValueError(f"fused_admission takes at most {_MAX_GRID_Y} "
                         f"replicas, got {R}")
    lib = _build.load("fused_admission", _SIGNATURES)
    out = torch.empty((R, N), dtype=torch.bool, device=res_q.device)
    with torch.cuda.device(res_q.device):
        err = lib.fused_admission_launch(
            res_q.data_ptr(), pkey.data_ptr(), enq_wave.data_ptr(),
            free.data_ptr(), out.data_ptr(), R, N, free.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_admission: kernel launch failed with "
                           f"CUDA error {err}")
    fused_admission.launches += 1
    return out


fused_admission.launches = 0
