"""Constants and layouts the PyTorch port shares with the reference engines.

The numpy heap engine of :mod:`repro.core.des` is not ported: it is the
oracle, and the port's tests run the reference's own. What the port's
engine and host side need of that module is copied here: the
admission-policy codes, the f32 "never" sentinel, the flat-tensor layouts
of the controller, trigger and probe headers with the f32 tick-grid walk
that sizes the engine's recording buffers, the decoders of those buffers,
and ``single_station_fifo``, the f64 oracle of the ``queue_scan`` kernel
and the reliability repair queue, which ``chip_smoke.py`` runs on the
card's machine where the reference is not installed.
"""
from __future__ import annotations

import functools

import numpy as np

POLICY_FIFO, POLICY_PRIORITY, POLICY_SJF = 0, 1, 2
POLICY_NAMES = ["fifo", "priority", "sjf"]

# ControllerParams flat-tensor layout (compiled by
# repro_torch.ops.capacity.ReactiveController): CTRL_HEADER leading scalars
# [interval_s, cooldown_s, t_first, t_end], then CTRL_FIELDS per resource
# [high watermark, low watermark, step, min_cap, max_cap, base].
CTRL_HEADER = 4
CTRL_FIELDS = 6
CTRL_INTERVAL, CTRL_COOLDOWN, CTRL_T_FIRST, CTRL_T_END = range(CTRL_HEADER)

# THE f32 "never" sentinel, shared bit-for-bit with the reference engines.
# Finite in f32 on purpose (float("inf") would poison min reductions).
CTRL_INF = np.float32(3.0e38)


def unpack_controller(ctrl):
    """Decode a flat ControllerParams tensor into
    ``(interval, cooldown, t_first, t_end, high, low, step, min_cap,
    max_cap, base)``; the last six are per-resource columns. Plain strided
    slicing on the last axis, so a ``[C]`` row or a ``[R, C]`` batch, numpy
    or torch, all work."""
    return (ctrl[..., CTRL_INTERVAL], ctrl[..., CTRL_COOLDOWN],
            ctrl[..., CTRL_T_FIRST], ctrl[..., CTRL_T_END],
            ctrl[..., CTRL_HEADER + 0::CTRL_FIELDS],
            ctrl[..., CTRL_HEADER + 1::CTRL_FIELDS],
            ctrl[..., CTRL_HEADER + 2::CTRL_FIELDS],
            ctrl[..., CTRL_HEADER + 3::CTRL_FIELDS],
            ctrl[..., CTRL_HEADER + 4::CTRL_FIELDS],
            ctrl[..., CTRL_HEADER + 5::CTRL_FIELDS])


# the action-recording buffer must be preallocated before the loop; a grid
# bound beyond this is infeasible to carry through the wave loop
MAX_CTRL_SLOTS = 1 << 24


def ctrl_tick_bound(ctrl) -> int:
    """Number of evaluation ticks a ControllerParams tensor can ever fire:
    the bound ``E`` on the engine's realized-action buffer (an action only
    happens at a tick). Walks the tick grid exactly as the engines advance
    it (f32 ``t += interval`` with the exhaust-on-no-advance guard). Returns
    0 for a disabled controller (``interval <= 0``) or an empty grid."""
    ctrl = np.asarray(ctrl, np.float32)
    if float(ctrl[CTRL_INTERVAL]) <= 0.0:
        return 0
    return _tick_bound_walk(float(ctrl[CTRL_INTERVAL]),
                            float(ctrl[CTRL_T_FIRST]),
                            float(ctrl[CTRL_T_END]))


@functools.lru_cache(maxsize=512)
def _tick_bound_walk(interval: float, t_first: float, t_end: float,
                     what: str = "controller evaluation") -> int:
    interval = np.float32(interval)
    t = np.float32(t_first)
    t_end = np.float32(t_end)
    count = 0
    while t <= t_end:
        count += 1
        if count > MAX_CTRL_SLOTS:
            raise ValueError(
                f"{what} grid exceeds {MAX_CTRL_SLOTS} ticks "
                f"(interval_s={float(interval)} over "
                f"[{float(t_first)}, {float(t_end)}]); the per-tick "
                "recording buffers cannot be preallocated at this size")
        nxt = np.float32(t + interval)
        if nxt <= t:          # f32 ulp: the engines exhaust the grid here
            break
        t = nxt
    return count


# TriggerParams flat-tensor header (compiled by
# repro_torch.ops.scenario.compile_fleet):
# [interval_s, cooldown_s, t_first, t_end, drift_threshold, arrival_delay_s].
# interval_s <= 0 disables the stage (same convention as the controller).
TRIG_FIELDS = 6
(TRIG_INTERVAL, TRIG_COOLDOWN, TRIG_T_FIRST, TRIG_T_END, TRIG_THRESHOLD,
 TRIG_DELAY) = range(TRIG_FIELDS)

# ProbeParams flat-tensor header (compiled by
# repro_torch.obs.probes.compile_probe): [interval_s, t_first, t_end,
# n_models]. interval_s <= 0 disables the stage; n_models masks the fleet
# reductions to the entry's own (unpadded) model rows.
PROBE_FIELDS = 4
PROBE_INTERVAL, PROBE_T_FIRST, PROBE_T_END, PROBE_N_MODELS = \
    range(PROBE_FIELDS)


def probe_channel_count(nres: int) -> int:
    """Probe-buffer channels: per resource queue depth, busy slots,
    effective capacity, controller delta and reliability delta; then the
    fleet's minimum performance and maximum staleness (order-independent
    reductions), then the live-pipeline count."""
    return 5 * nres + 3


# fleet-stage action kinds on the shared SimTrace action timeline
FLEET_ACT_TRIGGER, FLEET_ACT_REDEPLOY = 0, 1


def fleet_tick_grid(interval: float, t_first: float, t_end: float) -> np.ndarray:
    """The drift-evaluation tick times a trigger grid can ever fire, walked
    in f32 exactly as the engines advance it, so presampled per-tick
    tensors line up one-to-one with the evaluation instants. Returns f64
    values of the f32 grid."""
    n = _tick_bound_walk(float(interval), float(t_first), float(t_end),
                         what="trigger evaluation")
    interval = np.float32(interval)
    t = np.float32(t_first)
    out = np.zeros(n, np.float64)
    for i in range(n):
        out[i] = float(t)
        t = np.float32(t + interval)
    return out


def unpack_fleet_actions(buf, count):
    """Decode an engine's ``[A, 3]`` fleet-stage action buffer (first
    ``count`` rows valid: f32 time, action kind, model id) into
    ``(times [count] f64, kind [count] i64, model [count] i64)``."""
    acts = np.asarray(buf, np.float64)[: int(count)]
    return (acts[:, 0], np.rint(acts[:, 1]).astype(np.int64),
            np.rint(acts[:, 2]).astype(np.int64))


def fleet_trace_columns(fleet, arrival, pool_arr, fleet_act, fleet_n,
                        fleet_perf, fleet_stale):
    """Assemble the SimTrace fleet columns, and the pool-arrival override
    on ``arrival`` (activation times; NaN = the latent pipeline never
    triggered), from an engine's recorded fleet outputs (already sliced to
    the entry's own model/tick/pool extents). Returns ``(arrival, cols)``."""
    pool_arr = np.asarray(pool_arr, np.float64)
    arrival = np.asarray(arrival, np.float64).copy()
    arrival[fleet.pool_base:fleet.pool_base + pool_arr.shape[0]] = pool_arr
    ft, fk, fm = unpack_fleet_actions(fleet_act, fleet_n)
    cols = dict(
        fleet_perf=np.asarray(fleet_perf, np.float64),
        fleet_stale=np.asarray(fleet_stale, np.float64),
        fleet_ticks=np.asarray(fleet.tick_times, np.float64),
        fleet_times=ft, fleet_kind=fk, fleet_model=fm,
        fleet_pool_base=int(fleet.pool_base))
    return arrival, cols


def unpack_ctrl_actions(buf, count):
    """Decode an engine's ``[E, 1+nres]`` realized-action buffer (first
    ``count`` rows valid: f32 time in column 0, integer per-resource targets
    after) into ``(ctrl_times [count] f64, ctrl_caps [count, nres] i64)``."""
    acts = np.asarray(buf, np.float64)[: int(count)]
    return acts[:, 0], np.rint(acts[:, 1:]).astype(np.int64)


def unpack_rel_actions(buf, count):
    """Decode an engine's ``[RV, 1+nres]`` reliability-event buffer (f32
    time, then the integer *cumulative* per-resource delta) into
    ``(rel_times [count] f64, rel_caps [count, nres] i64)``: the row layout
    of the controller's buffer."""
    return unpack_ctrl_actions(buf, count)


def single_station_fifo(ready: np.ndarray, service: np.ndarray,
                        capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact c-server FIFO queue for ONE resource, slots in f64: the oracle
    of the ``queue_scan`` kernel and the reliability repair-crew queue (a
    copy of :func:`repro.core.des.single_station_fifo`). Returns (start,
    finish)."""
    order = np.argsort(ready, kind="stable")
    slots = np.zeros(capacity)
    start = np.empty_like(ready)
    finish = np.empty_like(ready)
    for j in order:
        k = int(np.argmin(slots))
        s = max(ready[j], slots[k])
        start[j] = s
        finish[j] = s + service[j]
        slots[k] = finish[j]
    return start, finish
