"""The numpy heap engine (SimPy semantics, numpy + ``heapq``) and the
constants and layouts the port's engines share (mirrors
:mod:`repro.core.des`).

:func:`simulate` is the oracle of the batched engine
(:mod:`repro_torch.core.vdes`): capacity-constrained resources with queue
admission ordered by a pluggable policy (FIFO / PRIORITY / SJF), pipelines
as sequential task chains, and, through an optional
:class:`repro_torch.ops.scenario.CompiledScenario`, piecewise-constant
capacity schedules, stochastic task failures with bounded
exponential-backoff retries (a failing attempt holds its slot for
``fail_holds_frac`` of its service time) and a closed-loop controller. It
runs on the host, in f64, with no torch in the loop, and equals the
reference's ``des.simulate`` bit for bit on any workload: every f32 and
f64 operation is the reference's, in the reference's order.

Wave semantics (shared with ``vdes``): all events at the same timestamp
are retired together: finishes first (slots released, successor tasks
ready at the same instant; a failed attempt re-queues after its backoff
delay), then arrivals and re-queues, then the pending capacity change,
then the reliability event and the controller evaluation (if due), then
one admission round per resource, then the fleet and probe stages.
Admission order key: (policy key, enqueue wave, pipeline id), the integer
wave counter breaking FIFO ties exactly as in ``vdes``. The returned
:class:`~repro_torch.core.model.SimTrace` carries the wave count, so
tests assert wave-for-wave parity.

The controller, fleet and probe stages compute in **float32**, though the
rest of the engine is f64, so their decisions agree bit for bit with the
batched engine on integer-time workloads. Controller, trigger and probe
ticks join the next-event minimum; their grids end at their ``t_end``,
which keeps the loop finite even when a scale-to-zero controller stalls
the queue forever. A capacity decrease never preempts running jobs: the
free-slot count goes negative and admission stalls until jobs drain.

Beside the engine: the admission-policy codes, the f32 "never" sentinel,
the flat-tensor layouts of the controller, trigger and probe headers with
the f32 tick-grid walk that sizes the batched engine's recording buffers,
the decoders of those buffers, and the single-station FIFO oracles of the
``queue_scan`` kernel and the reliability repair queue.
"""
from __future__ import annotations

import functools
import heapq
from typing import Optional

import numpy as np

from repro_torch.core import model as M
from repro_torch.core.metrics import (FLEET_PERF0, fleet_performance_acc,
                                      fleet_staleness)

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


# mutable fleet-stage loop variables, in adoption order — the resume /
# return_state state-dict keys for the windowed-cut hooks below
_FLEET_STATE_KEYS = ("fl_perf0", "fl_dep", "fl_acc", "fl_dep_tick",
                     "fl_fire", "t_fleet", "fl_tick", "pool_model",
                     "pool_next", "pool_arr", "redeployed", "fleet_perf",
                     "fleet_stale")


def _policy_key(policy: int, wl: M.Workload, svc_val: float,
                pid: int) -> float:
    if policy == POLICY_PRIORITY:
        return -float(wl.priority[pid])
    if policy == POLICY_SJF:
        return float(svc_val)
    return 0.0


def simulate(wl: M.Workload, platform: Optional[M.PlatformConfig] = None,
             policy: int = POLICY_FIFO, scenario=None,
             fleet=None, probe=None, reliability=None, *,
             time_budget: Optional[float] = None,
             resume: Optional[dict] = None, return_state: bool = False):
    """Run ``wl`` on ``platform`` under ``policy`` and return its
    :class:`~repro_torch.core.model.SimTrace` (with ``return_state``,
    ``(trace, state)``).

    ``scenario`` is a :class:`repro_torch.ops.scenario.CompiledScenario`.
    ``fleet`` is a :class:`repro_torch.ops.scenario.CompiledFleet`: the
    model lifecycle (run-time view) stage. ``wl`` must then be the
    *extended* workload — the exogenous pipelines followed by the fleet's
    preallocated pool of latent retraining pipelines (rows from
    ``fleet.pool_base``, arrival ``inf`` = not yet activated). The stage
    mirrors ``vdes._fleet_stage`` in **float32** (like the controller), so
    drift / trigger / redeploy decisions agree bit-for-bit with the batched
    engine.

    ``probe`` is a :class:`repro_torch.obs.probes.CompiledProbe`: the
    in-loop telemetry stage. At every probe tick (the same f32 tick-grid
    machinery as controller/trigger; ticks join the next-event minimum and
    keep the loop alive until the grid exhausts) the live engine state —
    per-resource queue depth, busy slots, effective capacity, controller
    delta, fleet min-performance / max-staleness — is sampled in f32 into a
    preallocated ``[E, K]`` buffer, mirroring ``vdes._probe_stage``
    op-for-op. The stage is physics-invisible: task timestamps are
    identical with and without a probe.

    ``reliability`` is a :class:`repro_torch.reliability.compile.
    CompiledReliability`: a pre-sampled timeline of correlated domain
    outage / repair-return / spot-eviction capacity deltas. Events join the
    control stage's capacity-delta machinery (``free`` moves, drain
    semantics — a down event never preempts running jobs) and are recorded
    (f32 time + integer cumulative delta) into the trace's
    ``rel_times``/``rel_caps`` timeline, mirroring ``vdes``'s reliability
    buffer event-for-event. Like the capacity schedule — and unlike the
    controller/probe grids — pending reliability events do NOT keep the
    loop alive: events after the workload drains never fire (availability
    integrals use the compile-time tensors instead).

    ``time_budget`` / ``resume`` / ``return_state`` mirror the vdes hooks
    (the windowed-cut semantics the streaming driver and the compaction
    engine rely on): the loop stops BEFORE processing any wave whose
    next-event time exceeds ``time_budget``, so a boundary is a bit-exact
    cut; with ``return_state=True`` the call returns ``(trace, state)``
    where ``state`` is an opaque dict of every mutable loop variable, and a
    later call with ``resume=state`` (same workload/scenario/fleet/probe
    tensors) continues wave-for-wave as if never interrupted. The state is
    adopted by reference — callers must not mutate it between calls."""
    platform = platform or M.PlatformConfig()
    service = wl.service_time(platform.datastore)
    n, T = wl.task_type.shape
    caps = platform.capacities
    nres = caps.shape[0]

    if scenario is not None:
        cap_times = np.asarray(scenario.cap_times, np.float64)
        cap_vals = np.asarray(scenario.cap_vals, np.int64)
        attempts_req = np.maximum(np.asarray(scenario.attempts, np.int64), 1)
        bo_base, bo_mult, bo_cap = (float(x) for x in scenario.backoff)
        caps = cap_vals[0].copy()
        att_svc = getattr(scenario, "attempt_service", None)
        if att_svc is not None:
            att_svc = np.asarray(att_svc, np.float64)
        ctrl = getattr(scenario, "controller", None)
        holds_frac = float(getattr(scenario, "fail_holds_frac", 1.0))
    else:
        cap_times = np.zeros(1, np.float64)
        cap_vals = caps.astype(np.int64)[None, :]
        attempts_req = np.ones((n, T), np.int64)
        bo_base, bo_mult, bo_cap = 0.0, 2.0, 3600.0
        att_svc = None
        ctrl = None
        holds_frac = 1.0
    K = cap_times.shape[0]
    # per-attempt service lookup: attempt k of a task runs
    # attempt_service[..., min(k, A_svc-1)] (falls back to the base time)
    A_svc = att_svc.shape[2] if att_svc is not None else 1

    def svc_of(pid: int, tidx: int, k: int) -> float:
        if att_svc is None:
            return float(service[pid, tidx])
        return float(att_svc[pid, tidx, min(k, A_svc - 1)])

    # closed-loop controller state — all float32 on purpose (see module
    # docstring): decisions must agree bit-for-bit with the batched engine
    f32 = np.float32
    if ctrl is not None:
        ctrl = np.asarray(ctrl, f32)
        if float(ctrl[CTRL_INTERVAL]) <= 0.0:
            ctrl = None
    if ctrl is not None:
        (c_interval, c_cooldown, c_first, c_end, c_high, c_low, c_step,
         c_min, c_max, c_base) = unpack_controller(ctrl)
        ctrl_cap = c_base.copy()                      # continuous state, f32
        ctrl_tgt = np.rint(c_base).astype(np.int64)   # integer target
        base_i = ctrl_tgt.copy()
        t_eval = c_first if c_first <= c_end else CTRL_INF
        t_act = -CTRL_INF
    # realized capacity timeline: every controller action (f32 time +
    # integer per-resource target) — what ops.accounting.realized_schedule
    # splices onto the planned schedule for exact cost/utilization under
    # closed-loop control. Mirrors vdes's [E, 1+nres] action buffer.
    ctrl_actions: list = []

    # ---- model-lifecycle (fleet) stage state — float32 like the controller
    # (vdes._fleet_stage must agree bit-for-bit). The trigger tick grid is
    # walked exactly as the controller's; the pool of latent retraining
    # pipelines occupies the trailing rows of the extended workload.
    fl = fleet
    if fl is not None and \
            float(np.asarray(fl.trig, f32)[TRIG_INTERVAL]) <= 0.0:
        fl = None
    if fl is not None:
        trig = np.asarray(fl.trig, f32)
        (f_interval, f_cooldown, f_first, f_end, f_thr, f_delay) = (
            f32(x) for x in trig[:TRIG_FIELDS])
        fleet_t = np.asarray(fl.fleet, f32)
        M_ = fleet_t.shape[0]
        fl_obs = np.asarray(fl.obs_noise, f32)       # [E, M]
        fl_inc = np.asarray(fl.drift_inc, f32)       # [E, M]
        pool_gain = np.asarray(fl.pool_gain, f32)    # [P]
        pool_base = int(fl.pool_base)
        P = pool_gain.shape[0]
        E_f = fl_obs.shape[0]
        fl_perf0 = fleet_t[:, FLEET_PERF0].copy()
        fl_dep = np.zeros(M_, f32)
        fl_acc = np.zeros(M_, f32)        # accumulated drift loss
        fl_dep_tick = np.full(M_, -1, np.int64)   # accrue from tick > this
        fl_fire = np.full(M_, -CTRL_INF, f32)
        t_fleet = f_first if f_first <= f_end else CTRL_INF
        fl_tick = 0
        pool_model = np.full(P, -1, np.int64)
        pool_next = 0
        pool_arr = np.full(P, np.nan, np.float64)
        redeployed = np.zeros(P, bool)
        fleet_perf = np.full((E_f, M_), np.nan, f32)
        fleet_stale = np.full((E_f, M_), np.nan, f32)
    fleet_actions: list = []

    # ---- probe (telemetry) stage state — float32 like the controller
    pr = probe
    if pr is not None and \
            float(np.asarray(pr.header, f32)[PROBE_INTERVAL]) <= 0.0:
        pr = None
    if pr is not None:
        hdr = np.asarray(pr.header, f32)
        p_interval, p_first, p_end = (f32(hdr[PROBE_INTERVAL]),
                                      f32(hdr[PROBE_T_FIRST]),
                                      f32(hdr[PROBE_T_END]))
        E_p = int(np.asarray(pr.times).shape[0])
        K_p = probe_channel_count(nres)
        t_probe = p_first if p_first <= p_end else CTRL_INF
        p_tick = 0
        probe_vals = np.full((E_p, K_p), np.nan, f32)

    # ---- reliability stage state: a pre-sampled capacity-delta timeline
    # (f32 grid, compared exactly — times are f64 values of the compiled
    # f32 grid, the same convention as the controller tick clock)
    rel = reliability
    if rel is not None and np.asarray(rel.times).shape[0] == 0:
        rel = None
    if rel is not None:
        rel_times = np.asarray(rel.times, np.float64)   # exact f32 values
        rel_deltas = np.asarray(rel.deltas, np.int64)
        n_rel = rel_times.shape[0]
        rel_ptr = 0
        rel_cum = np.zeros(nres, np.int64)
    rel_actions: list = []

    start = np.full((n, T), np.nan)
    finish = np.full((n, T), np.nan)
    ready = np.full((n, T), np.nan)
    attempts_out = np.zeros((n, T), np.int64)
    # per-attempt recording width covers every attempt that can execute;
    # with no retries anywhere the single-attempt records are already
    # exact, so skip the buffers (same condition as vdes.simulate_to_trace)
    A = int(max(attempts_req.max(), A_svc, 1))
    if scenario is not None and A > 1:
        att_start = np.full((n, T, A), np.nan)
        att_finish = np.full((n, T, A), np.nan)
    else:
        att_start = att_finish = None

    free = cap_vals[0].astype(np.int64).copy()
    # per-resource heaps of (key, wave, pid, tidx)
    waiting: list[list] = [[] for _ in range(nres)]
    task_idx = np.zeros(n, np.int64)
    att = np.zeros(n, np.int64)       # failed attempts on the current task
    wave = 0
    cap_ptr = 1

    # event heap: (time, kind, pid); kind 0 = finish, 1 = arrival/re-queue
    # (finishes processed before arrivals at equal time). Non-finite
    # arrivals are latent retraining-pool rows: no event until a trigger
    # activates them.
    ev: list = [(float(wl.arrival[i]), 1, i) for i in range(n)
                if np.isfinite(wl.arrival[i])]
    heapq.heapify(ev)

    if resume is not None:
        # adopt every mutable loop variable by reference (the fresh
        # allocations above are discarded); static/derived tensors were
        # recomputed identically from the same inputs
        st = resume
        start, finish, ready = st["start"], st["finish"], st["ready"]
        attempts_out = st["attempts_out"]
        att_start, att_finish = st["att_start"], st["att_finish"]
        free, waiting = st["free"], st["waiting"]
        task_idx, att = st["task_idx"], st["att"]
        wave, cap_ptr, ev = st["wave"], st["cap_ptr"], st["ev"]
        if ctrl is not None:
            ctrl_cap, ctrl_tgt = st["ctrl_cap"], st["ctrl_tgt"]
            t_eval, t_act = st["t_eval"], st["t_act"]
            ctrl_actions = st["ctrl_actions"]
        if fl is not None:
            (fl_perf0, fl_dep, fl_acc, fl_dep_tick, fl_fire, t_fleet,
             fl_tick, pool_model, pool_next, pool_arr, redeployed,
             fleet_perf, fleet_stale) = (st[k] for k in _FLEET_STATE_KEYS)
            fleet_actions = st["fleet_actions"]
        if pr is not None:
            t_probe, p_tick, probe_vals = (st["t_probe"], st["p_tick"],
                                           st["probe_vals"])
        if rel is not None:
            rel_ptr, rel_cum = st["rel_ptr"], st["rel_cum"]
            rel_actions = st["rel_actions"]

    def enqueue(pid: int, t: float) -> None:
        tidx = int(task_idx[pid])
        r = int(wl.task_res[pid, tidx])
        ready[pid, tidx] = t
        k = _policy_key(policy, wl, svc_of(pid, tidx, int(att[pid])), pid)
        heapq.heappush(waiting[r], (k, wave, pid, tidx))

    # mirror: vdes._admission_stage — one ranked admission round per
    # resource; heap order matches the fused lexicographic sort keys
    def admit(t: float) -> None:
        for r in range(nres):
            while free[r] > 0 and waiting[r]:
                _, _, pid, tidx = heapq.heappop(waiting[r])
                free[r] -= 1
                k = int(att[pid])
                s = svc_of(pid, tidx, k)
                # a failing attempt (known from the pre-sampled attempt
                # tensor) may hold its slot for only a fraction of s
                if holds_frac < 1.0 and k + 1 < attempts_req[pid, tidx]:
                    s = holds_frac * s
                start[pid, tidx] = t
                finish[pid, tidx] = t + s
                attempts_out[pid, tidx] += 1
                if att_start is not None:
                    ka = min(k, A - 1)
                    att_start[pid, tidx, ka] = t
                    att_finish[pid, tidx, ka] = t + s
                heapq.heappush(ev, (t + s, 0, pid))

    while True:
        t_heap = ev[0][0] if ev else np.inf
        t_cap = cap_times[cap_ptr] if cap_ptr < K else np.inf
        t_ctrl = float(t_eval) if ctrl is not None and t_eval < CTRL_INF \
            else np.inf
        t_fl = float(t_fleet) if fl is not None and t_fleet < CTRL_INF \
            else np.inf
        t_pr = float(t_probe) if pr is not None and t_probe < CTRL_INF \
            else np.inf
        t_rel = float(rel_times[rel_ptr]) if rel is not None \
            and rel_ptr < n_rel else np.inf
        # mirror: vdes._select_events — the global next-event minimum over
        # task events, capacity changes, reliability events, and the
        # controller/fleet/probe grids
        t_star = min(t_heap, t_cap, t_ctrl, t_fl, t_pr, t_rel)
        if not np.isfinite(t_star):
            break                       # stalled forever: remaining tasks NaN
        if time_budget is not None and t_star > time_budget:
            break   # windowed cut: waves past the guard wait for a resume
        # mirror: vdes._completion_stage — finishes release slots, failed
        # attempts re-queue after backoff, arrivals/successors enqueue
        wave_ev = []
        while ev and ev[0][0] == t_star:
            wave_ev.append(heapq.heappop(ev))
        for _, kind, pid in wave_ev:       # finishes sort before arrivals
            if kind == 0:
                tidx = int(task_idx[pid])
                free[int(wl.task_res[pid, tidx])] += 1
                if att[pid] + 1 < attempts_req[pid, tidx]:
                    # attempt failed: re-queue after bounded exp. backoff
                    delay = min(bo_base * bo_mult ** att[pid], bo_cap)
                    att[pid] += 1
                    heapq.heappush(ev, (t_star + delay, 1, pid))
                else:
                    att[pid] = 0
                    task_idx[pid] += 1
                    if task_idx[pid] < wl.n_tasks[pid]:
                        enqueue(pid, t_star)
            else:
                enqueue(pid, t_star)
        if cap_ptr < K and cap_times[cap_ptr] == t_star:
            free += cap_vals[cap_ptr] - cap_vals[cap_ptr - 1]
            cap_ptr += 1
        # mirror: vdes._control_stage — reliability capacity-delta event
        # (domain outage / repair return / spot eviction); same drain
        # semantics as a scheduled capacity decrease, applied before the
        # controller evaluates so it reacts to post-outage capacity
        if rel is not None and rel_ptr < n_rel and \
                rel_times[rel_ptr] == t_star:
            d = rel_deltas[rel_ptr]
            free += d
            rel_cum = rel_cum + d
            rel_actions.append((f32(t_star), rel_cum.copy()))
            rel_ptr += 1
        # mirror: vdes._control_stage — closed-loop evaluation tick (f32
        # arithmetic, operation-for-operation)
        if ctrl is not None and float(t_eval) == t_star:
            qlen = np.array([len(waiting[r]) for r in range(nres)], np.int64)
            cap_eff = cap_vals[cap_ptr - 1] + ctrl_tgt - base_i
            if rel is not None:
                cap_eff = cap_eff + rel_cum
            per_slot = qlen.astype(f32) / np.maximum(cap_eff, 1).astype(f32)
            if f32(t_star) - t_act >= c_cooldown:
                new_cap = np.where(
                    per_slot > c_high, ctrl_cap * (f32(1.0) + c_step),
                    np.where(per_slot < c_low,
                             ctrl_cap * (f32(1.0) - c_step), ctrl_cap))
                new_cap = np.clip(new_cap, c_min, c_max).astype(f32)
                new_tgt = np.rint(new_cap).astype(np.int64)
                if (new_cap != ctrl_cap).any():
                    t_act = f32(t_star)
                if (new_tgt != ctrl_tgt).any():
                    ctrl_actions.append((f32(t_star), new_tgt.copy()))
                free += new_tgt - ctrl_tgt
                ctrl_cap, ctrl_tgt = new_cap, new_tgt
            t_nxt = f32(t_eval + c_interval)
            # a tick that cannot advance past the f32 ulp would spin this
            # loop forever — exhaust the grid instead (mirrored in vdes)
            t_eval = t_nxt if (t_nxt <= c_end and t_nxt > t_eval) \
                else CTRL_INF
        admit(t_star)
        # mirror: vdes._fleet_stage — model lifecycle (f32 arithmetic,
        # operation-for-operation). Runs AFTER admission:
        # (a) retraining pipelines that completed this wave redeploy their
        # model (drift state resets); (b) if this wave is a drift-evaluation
        # tick, the [M] drift algebra is evaluated, performance/staleness
        # timelines recorded, and firing triggers activate latent pool
        # pipelines (arrival t_star + delay). Both action kinds append to
        # the shared action timeline.
        if fl is not None:
            # (a) redeploys, in pool-slot order (same summation order as
            # vdes's segment_sum over slots)
            gain_m = np.zeros(M_, f32)
            hit = np.zeros(M_, bool)
            for j in range(pool_next):
                if redeployed[j] or task_idx[pool_base + j] < \
                        wl.n_tasks[pool_base + j]:
                    continue
                redeployed[j] = True
                m_id = int(pool_model[j])
                gain_m[m_id] += pool_gain[j]
                hit[m_id] = True
                fleet_actions.append((f32(t_star), FLEET_ACT_REDEPLOY, m_id))
            if hit.any():
                fl_perf0 = np.where(
                    hit, np.clip(fl_perf0 + gain_m, f32(0.4), f32(0.995)),
                    fl_perf0).astype(f32)
                fl_dep = np.where(hit, f32(t_star), fl_dep).astype(f32)
                fl_acc = np.where(hit, f32(0.0), fl_acc).astype(f32)
                fl_dep_tick = np.where(hit, fl_tick, fl_dep_tick)
            # (b) drift-evaluation tick: drift accrues per COMPLETED
            # interval (the partial interval behind a redeploy is dropped —
            # dep_tick gates the first accrual after a redeploy)
            if t_fleet < CTRL_INF and float(t_fleet) == t_star:
                e = min(fl_tick, E_f - 1)
                t32 = f32(t_star)
                dt = np.maximum(t32 - fl_dep, f32(0.0)).astype(f32)
                acc_new = np.where(e > fl_dep_tick,
                                   (fl_acc + fl_inc[e]).astype(f32), fl_acc)
                perf = fleet_performance_acc(fl_perf0, acc_new, dt, fleet_t,
                                             xp=np).astype(f32)
                fleet_perf[e] = perf
                fleet_stale[e] = fleet_staleness(fl_perf0, perf,
                                                 xp=np).astype(f32)
                obs = (perf + fl_obs[e]).astype(f32)
                drift = (fl_perf0 - obs).astype(f32)
                want = (drift > f_thr) & ((t32 - fl_fire) >= f_cooldown)
                arr_t = f32(t32 + f_delay)
                for m_id in np.nonzero(want)[0]:
                    if pool_next >= P:
                        break           # injection budget exhausted
                    j = pool_next
                    pool_next += 1
                    pool_model[j] = m_id
                    pool_arr[j] = float(arr_t)
                    fl_fire[m_id] = t32
                    fleet_actions.append((t32, FLEET_ACT_TRIGGER, int(m_id)))
                    heapq.heappush(ev, (float(arr_t), 1, pool_base + j))
                fl_acc = acc_new
                t_nxt = f32(t_fleet + f_interval)
                t_fleet = t_nxt if (t_nxt <= f_end and t_nxt > t_fleet) \
                    else CTRL_INF
                fl_tick += 1
        # mirror: vdes._probe_stage — in-loop telemetry sampling (f32,
        # operation-for-operation). Runs LAST in the wave
        # so it sees the settled post-admission/post-fleet state at t_star.
        # Physics-invisible: reads state, writes only the probe buffer.
        if pr is not None and t_probe < CTRL_INF and float(t_probe) == t_star:
            e = min(p_tick, E_p - 1)
            sched_now = cap_vals[cap_ptr - 1]
            delta = (ctrl_tgt - base_i) if ctrl is not None \
                else np.zeros(nres, np.int64)
            rdelta = rel_cum if rel is not None else np.zeros(nres, np.int64)
            cap_eff = sched_now + delta + rdelta
            row = np.empty(K_p, f32)
            row[0:nres] = [len(waiting[r]) for r in range(nres)]
            row[nres:2 * nres] = cap_eff - free      # busy = running jobs
            row[2 * nres:3 * nres] = cap_eff
            row[3 * nres:4 * nres] = delta
            row[4 * nres:5 * nres] = rdelta
            if fl is not None:
                dtp = np.maximum(f32(t_star) - fl_dep, f32(0.0)).astype(f32)
                perf_p = fleet_performance_acc(fl_perf0, fl_acc, dtp,
                                               fleet_t, xp=np).astype(f32)
                row[5 * nres] = perf_p.min()
                row[5 * nres + 1] = fleet_staleness(fl_perf0, perf_p,
                                                    xp=np).astype(f32).max()
            else:
                row[5 * nres] = row[5 * nres + 1] = np.nan
            # live pipelines = queued (waiting heaps) + running (each
            # running pipeline holds exactly one kind-0 finish event) —
            # integer, exact in f32, matches vdes's phase-mask count
            row[5 * nres + 2] = (sum(len(waiting[r]) for r in range(nres))
                                 + sum(1 for e_ in ev if e_[1] == 0))
            probe_vals[e] = row
            t_nxt = f32(t_probe + p_interval)
            t_probe = t_nxt if (t_nxt <= p_end and t_nxt > t_probe) \
                else CTRL_INF
            p_tick += 1
        wave += 1
        if not ev and not any(waiting) and \
                (fl is None or not (t_fleet < CTRL_INF)) and \
                (pr is None or not (t_probe < CTRL_INF)):
            break                       # all pipelines done (or never arrive)

    ctrl_times = ctrl_caps = None
    if ctrl is not None:     # an enabled controller's timeline, maybe empty
        ctrl_times = np.array([t for t, _ in ctrl_actions], np.float64)
        ctrl_caps = (np.stack([c for _, c in ctrl_actions])
                     if ctrl_actions else np.zeros((0, nres), np.int64))
    rel_times_out = rel_caps_out = None
    if rel is not None:      # enabled reliability's timeline, maybe empty
        rel_times_out = np.array([t for t, _ in rel_actions], np.float64)
        rel_caps_out = (np.stack([c for _, c in rel_actions])
                        if rel_actions else np.zeros((0, nres), np.int64))

    arrival_out = np.asarray(wl.arrival, np.float64)
    fl_cols = {}
    if fl is not None:
        act_buf = (np.array([(t, k, m) for t, k, m in fleet_actions],
                            np.float64).reshape(-1, 3))
        arrival_out, fl_cols = fleet_trace_columns(
            fl, arrival_out, pool_arr, act_buf, len(fleet_actions),
            fleet_perf, fleet_stale)

    tr = M.SimTrace(
        start=start, finish=finish, ready=ready,
        n_tasks=wl.n_tasks.astype(np.int64), task_res=wl.task_res,
        task_type=wl.task_type, arrival=arrival_out,
        capacities=np.asarray(caps, np.int64),
        attempts=attempts_out if scenario is not None else None,
        completed=(task_idx >= wl.n_tasks)
        if scenario is not None or fl is not None else None,
        att_start=att_start,
        att_finish=att_finish,
        ctrl_times=ctrl_times,
        ctrl_caps=ctrl_caps,
        rel_times=rel_times_out,
        rel_caps=rel_caps_out,
        probe_times=np.asarray(pr.times, np.float64)
        if pr is not None else None,
        probe_vals=probe_vals.astype(np.float64) if pr is not None else None,
        waves=wave,
        **fl_cols,
    )
    if not return_state:
        return tr
    state = dict(start=start, finish=finish, ready=ready,
                 attempts_out=attempts_out, att_start=att_start,
                 att_finish=att_finish, free=free, waiting=waiting,
                 task_idx=task_idx, att=att, wave=wave, cap_ptr=cap_ptr,
                 ev=ev)
    if ctrl is not None:
        state.update(ctrl_cap=ctrl_cap, ctrl_tgt=ctrl_tgt, t_eval=t_eval,
                     t_act=t_act, ctrl_actions=ctrl_actions)
    if fl is not None:
        state.update(zip(_FLEET_STATE_KEYS,
                         (fl_perf0, fl_dep, fl_acc, fl_dep_tick, fl_fire,
                          t_fleet, fl_tick, pool_model, pool_next, pool_arr,
                          redeployed, fleet_perf, fleet_stale)))
        state["fleet_actions"] = fleet_actions
    if pr is not None:
        state.update(t_probe=t_probe, p_tick=p_tick, probe_vals=probe_vals)
    if rel is not None:
        state.update(rel_ptr=rel_ptr, rel_cum=rel_cum,
                     rel_actions=rel_actions)
    return tr, state


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


def single_station_fifo_schedule(ready: np.ndarray, service: np.ndarray,
                                 cap_times: np.ndarray, cap_vals: np.ndarray,
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """Exact FIFO queue for ONE resource under a *non-decreasing* capacity
    schedule (server additions only): server k added at the step time becomes
    available from that instant. Extends :func:`single_station_fifo` —
    deterministic oracle for the engines' capacity-schedule path. Returns
    (start, finish).
    """
    cap_vals = np.asarray(cap_vals, np.int64)
    cap_times = np.asarray(cap_times, np.float64)
    if (np.diff(cap_vals) < 0).any():
        raise ValueError("the oracle handles capacity additions only")
    avail = np.repeat(cap_times, np.diff(np.concatenate([[0], cap_vals])))
    slots_free = np.zeros(avail.shape[0])
    order = np.argsort(ready, kind="stable")
    start = np.empty_like(np.asarray(ready, np.float64))
    finish = np.empty_like(start)
    for j in order:
        t_slot = np.maximum(slots_free, avail)
        k = int(np.argmin(t_slot))
        s = max(ready[j], t_slot[k])
        start[j] = s
        finish[j] = s + service[j]
        slots_free[k] = finish[j]
    return start, finish
