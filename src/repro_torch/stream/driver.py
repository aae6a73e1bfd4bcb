"""Windowed streaming simulation driver (mirrors :mod:`repro.stream.driver`).

``stream_simulate`` runs an arrival-ordered task stream (any
:class:`repro_torch.stream.sources.TraceSource`) through the batched
engine in *horizon windows*: ingest every row arriving up to the next
boundary, run the wave loop with the boundary as the engine's
``time_budget`` (the loop stops before any wave past it), retire DONE
pipelines out of the working set, append the next window's rows, and
resume. The working set is sized by the *live* backlog, not the stream's
length, while the queue/controller/fleet/probe state — every scalar, tick
cursor and recording buffer — rides the engine's resume carry across each
boundary. The carry stays on the device: a boundary gathers the retained
rows, appends the new rows' fresh state and reads back only the phases of
the window's rows and the records of the retired ones. Every wave of every
window launches ``fused_admission`` on the card
(``admission_sort="kernel"``).

Bit-parity argument (twin-tested against :func:`oneshot_reference` and the
reference's driver):

  - a row absent from window ``k`` has ``float32(arrival) > boundary_k``
    (the ingestion buffer cuts on the engine clock's f32 cast), and the
    loop stops before any wave with ``t_star > boundary_k``, so the row
    joining in window ``k+1`` is invisible to every wave it could touch;
  - retired rows are DONE (inert forever; their records are taken at
    retirement);
  - the working layout is ``[retained rows | new rows | retraining pool |
    padding]`` with retained and new rows each in ascending global-id
    order and every new id above every retained id: all pairwise row
    orders match the one-shot layout, so the admission tie-break decides
    identically, and the pool block stays contiguous at a per-window
    ``pool_base``;
  - new rows enter with the engine's own initial per-row state
    (NOT_ARRIVED, ``t_next = f32(arrival)``, NaN time tensors), and padding
    rows carry ``arrival = inf`` and are marked DONE: they never arrive and
    never keep the wave loop alive, so the last window stops where the
    one-shot run does.

With ``overlap=True`` window ``k+1``'s ingestion (synthesis, the per-block
failure draws and the upload of its rows) runs on a worker thread — on a
side CUDA stream on the card — while window ``k`` runs; an event joins it
before the rows are used. Each block draws from its own generator, so what
is drawn does not depend on the timing: ``overlap=False`` (ingestion after
the window) gives the same bits.

``oneshot_reference`` materializes the SAME stream — identical per-block
draws, identical pool/fleet/probe compiles — into one
``vdes.simulate_ensemble`` call: the parity oracle, and the fixed-horizon
baseline a streamed run's wall compares with.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core import trace, vdes
from repro_torch.core.batching import (batch_trace, stack_fleets,
                                       stack_probes, stack_scenarios,
                                       to_tensors)
from repro_torch.core.compaction import ROW_STATE_KEYS, _bucket
from repro_torch.core.des import (CTRL_INF, POLICY_FIFO, ctrl_tick_bound,
                                  unpack_ctrl_actions, unpack_fleet_actions)
from repro_torch.device import resolve_device
from repro_torch.stream.sources import TraceSource, WorkloadManager

_DONE = vdes._DONE

#: the engine's per-row inputs: content column, dtype, padding value
_ROW_INPUTS = (("arrival", "arrival", np.float32, float("inf")),
               ("n_tasks", "n_tasks", np.int32, 1),
               ("task_res", "task_res", np.int32, 0),
               ("service", "service", np.float32, 0.0),
               ("priority", "priority", np.float32, 0.0),
               ("attempts", "attempts", np.int32, 1),
               ("attempt_service", "att_svc", np.float32, 0.0))
_NAN_KEYS = ("start", "finish", "ready", "att_start", "att_finish")


def _block_seed(seed: int, block_idx: int) -> int:
    """Per-block failure-draw seed — the streamed and one-shot paths MUST
    fold identically for attempts/attempt_service parity."""
    return int(seed) + 7919 * int(block_idx)


_POOL_SALT = 0x9E37    # pool rows compile as their own pseudo-block


@dataclasses.dataclass
class StreamResult:
    """What a streamed run produces. ``records`` is None when a ``sink``
    consumed them as they retired (unbounded runs); the operational
    timelines (controller actions, fleet tensors, probe matrix) come from
    the final carry — the recording buffers ride every boundary as they
    are, so they are exactly the one-shot run's."""

    records: Optional[trace.TaskRecords]
    summary: Dict
    n_windows: int
    n_blocks: int
    n_pipelines: int            # exogenous pipelines ingested
    n_task_rows: int            # task records emitted (incl. retraining)
    waves: int
    peak_rows: int              # largest working width (memory proxy)
    peak_live: int              # largest live (unretired) row count
    wall_s: float
    ingest_s: float             # host-side synthesis + failure-draw time
    ctrl_times: Optional[np.ndarray] = None
    ctrl_caps: Optional[np.ndarray] = None
    fleet_cols: Optional[Dict] = None
    probe_times: Optional[np.ndarray] = None
    probe_vals: Optional[np.ndarray] = None


class _StreamPlan:
    """Everything shared between the windowed driver and the one-shot
    reference: the schedule/controller/backoff resolution, the per-block
    failure compiles (same seeds), the fleet/pool/probe compiles, and the
    static engine arguments. One plan, two executions — the basis of the
    parity gate."""

    def __init__(self, platform, policy, scenario, fleet, trigger, probe,
                 horizon_s, seed, params, admission_sort, device):
        from repro_torch.obs.probes import compile_probe
        from repro_torch.ops.capacity import static_schedule
        from repro_torch.ops.failures import RetryPolicy
        from repro_torch.ops.scenario import CompiledScenario

        self.platform = platform or M.PlatformConfig()
        self.policy = int(policy)
        self.horizon_s = float(horizon_s)
        self.seed = int(seed)
        self.params = params
        self.admission_sort = admission_sort
        self.device = device
        self.fleet_spec, self.trigger_spec = fleet, trigger
        self.caps = np.asarray(self.platform.capacities, np.int64)

        self.scenario = None            # ops.scenario.Scenario (or None)
        self.replay = None              # pre-compiled replay scenario
        if scenario is None:
            self.schedule = static_schedule(self.platform.capacities)
            self.controller = None
            self.backoff = RetryPolicy().backoff
            self.holds_frac = 1.0
            self.a_stat, self.has_asv = 1, False
        elif hasattr(scenario, "compile_schedule"):     # a Scenario spec
            self.scenario = scenario
            self.schedule = scenario.compile_schedule(
                self.platform, self.horizon_s, seed=self.seed,
                policy=self.policy, device=device)
            self.controller = (scenario.controller.compile(
                self.platform.capacities, self.horizon_s)
                if scenario.controller is not None else None)
            fm = scenario.failures
            self.backoff = (fm.retry.backoff if fm is not None
                            else RetryPolicy().backoff)
            self.holds_frac = (float(fm.fail_holds_frac)
                               if fm is not None else 1.0)
            self.a_stat = (fm.retry.max_retries + 1) if fm is not None else 1
            self.has_asv = bool(fm is not None and fm.resample_service)
        else:                                           # CompiledScenario
            self.replay = scenario
            self.schedule = scenario.schedule
            self.controller = scenario.controller
            self.backoff = scenario.backoff
            self.holds_frac = float(scenario.fail_holds_frac)
            asv = scenario.attempt_service
            self.a_stat = max(int(np.max(scenario.attempts)),
                              asv.shape[2] if asv is not None else 1)
            self.has_asv = asv is not None
            self._replay_off = 0
        self.n_attempt_slots = self.a_stat if self.a_stat > 1 else None
        self.n_ctrl_slots = (ctrl_tick_bound(self.controller) or None
                             if self.controller is not None else None)

        self.probe = None
        if probe is not None:
            n_models = fleet.n_models if fleet is not None else 0
            self.probe = compile_probe(probe, self.horizon_s,
                                       n_models=n_models)
        self.n_probe_slots = self.probe.n_ticks if self.probe else None
        self._CompiledScenario = CompiledScenario

    # -- per-block failure draws -------------------------------------------
    def block_attempts(self, wl: M.Workload, block_idx: int):
        """``(attempts [n, T] i64, attempt_service [n, T, A] | None)`` for
        one block — per-block seeds, so any two consumers of the same
        source draw identically."""
        if self.scenario is not None:
            comp = self.scenario.compile(
                wl, self.platform, self.horizon_s,
                seed=_block_seed(self.seed, block_idx), policy=self.policy,
                schedule=self.schedule, device=self.device)
            return np.asarray(comp.attempts, np.int64), comp.attempt_service
        if self.replay is not None:
            off = self._replay_off
            self._replay_off = off + wl.n
            att = np.asarray(self.replay.attempts[off:off + wl.n], np.int64)
            asv = (self.replay.attempt_service[off:off + wl.n]
                   if self.has_asv else None)
            return att, asv
        return np.ones(wl.task_type.shape, np.int64), None

    def on_block(self, gid0: int):
        """The :class:`WorkloadManager` hook: raw columns + service +
        failure draws + global pipeline ids."""
        counter = [gid0]

        def hook(wl: M.Workload, block_idx: int) -> Dict[str, np.ndarray]:
            att, asv = self.block_attempts(wl, block_idx)
            cols = dict(
                gid=np.arange(counter[0], counter[0] + wl.n, dtype=np.int64),
                arrival=np.asarray(wl.arrival, np.float64),
                n_tasks=np.asarray(wl.n_tasks, np.int32),
                task_type=np.asarray(wl.task_type, np.int32),
                task_res=np.asarray(wl.task_res, np.int32),
                service=np.asarray(
                    wl.service_time(self.platform.datastore), np.float64),
                read_bytes=np.asarray(wl.read_bytes, np.float64),
                write_bytes=np.asarray(wl.write_bytes, np.float64),
                framework=np.asarray(wl.framework, np.int32),
                priority=np.asarray(wl.priority, np.float32),
                attempts=att)
            if self.has_asv:
                cols["att_svc"] = np.asarray(asv, np.float64)
            counter[0] += wl.n
            return cols
        return hook

    # -- fleet / retraining pool -------------------------------------------
    def compile_fleet(self, wl: M.Workload):
        """``(CompiledFleet, pool content columns)`` — pool draws depend
        only on (trigger, platform, horizon, seed, params), so compiling
        against any workload of the stream gives the pool rows the
        one-shot reference appends."""
        from repro_torch.core.runtime import TriggerSpec
        from repro_torch.ops.scenario import compile_fleet
        trig = (self.trigger_spec if self.trigger_spec is not None
                else TriggerSpec())
        cf, ext = compile_fleet(self.fleet_spec, trig, wl, self.platform,
                                self.horizon_s, seed=self.seed,
                                params=self.params)
        n0, P = wl.n, cf.n_pool
        svc = np.asarray(ext.service_time(self.platform.datastore),
                         np.float64)[n0:]
        if self.scenario is not None:
            comp = self.scenario.compile(
                _rows_workload(ext, n0), self.platform, self.horizon_s,
                seed=_block_seed(self.seed, _POOL_SALT), policy=self.policy,
                schedule=self.schedule, device=self.device)
            att = np.asarray(comp.attempts, np.int64)
            asv = comp.attempt_service
        else:
            att = np.ones((P, ext.max_tasks), np.int64)
            asv = None
        pool = dict(
            arrival=np.asarray(ext.arrival, np.float64)[n0:],
            n_tasks=np.asarray(ext.n_tasks, np.int32)[n0:],
            task_type=np.asarray(ext.task_type, np.int32)[n0:],
            task_res=np.asarray(ext.task_res, np.int32)[n0:],
            service=svc,
            read_bytes=np.asarray(ext.read_bytes, np.float64)[n0:],
            write_bytes=np.asarray(ext.write_bytes, np.float64)[n0:],
            framework=np.asarray(ext.framework, np.int32)[n0:],
            priority=np.asarray(ext.priority, np.float32)[n0:],
            attempts=att)
        if self.has_asv:
            pool["att_svc"] = np.asarray(asv, np.float64)
        return cf, pool

    # -- engine kwargs ------------------------------------------------------
    def scenario_kwargs(self, attempts, att_svc, services, n_max):
        """The schedule/attempt/controller kwargs for one ensemble call,
        through the tested batching stacker, with the attempt-slot and
        controller-slot statics replaced by the plan's global ones."""
        comp = self._CompiledScenario(
            schedule=self.schedule, attempts=attempts, backoff=self.backoff,
            attempt_service=att_svc, controller=self.controller,
            fail_holds_frac=self.holds_frac)
        kw = stack_scenarios([comp], n_max, self.horizon_s,
                             services=[services], record_attempts=True,
                             record_ctrl=True)
        kw.pop("n_attempt_slots", None)
        kw.pop("n_ctrl_slots", None)
        return kw

    def statics(self) -> Dict:
        return dict(n_attempt_slots=self.n_attempt_slots,
                    admission_sort=self.admission_sort,
                    n_ctrl_slots=self.n_ctrl_slots,
                    n_probe_slots=self.n_probe_slots)


def _rows_workload(wl: M.Workload, lo: int) -> M.Workload:
    """Row-slice a workload (dataclass fields only)."""
    cols = {f.name: (v[lo:] if isinstance(v := getattr(wl, f.name),
                                          np.ndarray) else v)
            for f in dataclasses.fields(M.Workload)}
    return M.Workload(**cols)


def _cat(parts: List[np.ndarray]) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _merge(buf: Dict, segs: List[Dict]) -> Dict:
    if not segs:
        return buf
    return {k: _cat([buf[k]] + [s[k] for s in segs]) if buf[k].size
            else _cat([s[k] for s in segs]) for k in buf}


def _take(buf: Dict, idx: np.ndarray) -> Dict:
    return {k: v[idx] for k, v in buf.items()}


def _empty_buf(T: int, A: int, has_asv: bool) -> Dict[str, np.ndarray]:
    buf = dict(gid=np.zeros(0, np.int64), arrival=np.zeros(0, np.float64),
               n_tasks=np.zeros(0, np.int32),
               task_type=np.zeros((0, T), np.int32),
               task_res=np.zeros((0, T), np.int32),
               service=np.zeros((0, T), np.float64),
               read_bytes=np.zeros((0, T), np.float64),
               write_bytes=np.zeros((0, T), np.float64),
               framework=np.zeros(0, np.int32),
               priority=np.zeros(0, np.float32),
               attempts=np.ones((0, T), np.int64))
    if has_asv:
        buf["att_svc"] = np.zeros((0, T, A), np.float64)
    return buf


def _row_tensors(content: Dict, has_asv: bool, device) -> Dict:
    """The engine's per-row inputs ``[1, n, ...]`` of content rows, in the
    engine's dtypes (the f64 columns cast to f32 as the one-shot path's
    stacking casts them)."""
    out = {}
    for key, col, dtype, _ in _ROW_INPUTS:
        if col == "att_svc" and not has_asv:
            continue
        out[key] = torch.as_tensor(
            np.ascontiguousarray(content[col], dtype)[None], device=device)
    return out


def _pad_rows(proto: Dict, n: int) -> Dict:
    """``n`` inert padding rows for each per-row input of ``proto``."""
    pads = {key: pad for key, _, _, pad in _ROW_INPUTS}
    return {k: torch.full((1, n) + v.shape[2:], pads[k], dtype=v.dtype,
                          device=v.device) for k, v in proto.items()}


def _fresh_rows(key: str, proto: torch.Tensor, n: int, t_next: torch.Tensor,
                done: bool = False) -> torch.Tensor:
    """A fresh row's engine state, exactly as ``vdes`` initializes it
    (``t_next [1, n]`` the rows' f32 arrivals). ``done=True`` builds
    *padding* rows: DONE with an inf event time, so they neither admit,
    nor fire events, nor keep the wave loop alive."""
    shape = (1, n) + tuple(proto.shape[2:])
    if key == "t_next":
        return t_next.to(proto.dtype)
    if key == "phase" and done:
        return torch.full(shape, _DONE, dtype=proto.dtype,
                          device=proto.device)
    if key in _NAN_KEYS:
        return torch.full(shape, float("nan"), dtype=proto.dtype,
                          device=proto.device)
    return torch.zeros(shape, dtype=proto.dtype, device=proto.device)


def _extract_records(content: Dict, st: Dict, row_idx: np.ndarray,
                     gids: np.ndarray, caps: np.ndarray,
                     arrival: Optional[np.ndarray] = None
                     ) -> trace.TaskRecords:
    """Records of the given working-set rows (gathered on the device, read
    back), through the one flattener every engine uses, with pipeline ids
    remapped to global ids. ``arrival`` overrides the content arrivals
    (retraining-pool activation times; NaN rows are latent and drop out
    as on the one-shot path)."""
    idx = torch.as_tensor(row_idx, dtype=torch.long,
                          device=st["phase"].device)

    def sl(k, dtype=np.float64):
        return st[k][0][idx].cpu().numpy().astype(dtype)

    tr = M.SimTrace(
        start=sl("start"), finish=sl("finish"), ready=sl("ready"),
        n_tasks=content["n_tasks"].astype(np.int64),
        task_res=content["task_res"], task_type=content["task_type"],
        arrival=(arrival if arrival is not None else content["arrival"]),
        capacities=caps,
        attempts=sl("att_out", np.int64),
        completed=sl("phase", np.int64) == _DONE,
        att_start=sl("att_start") if "att_start" in st else None,
        att_finish=sl("att_finish") if "att_finish" in st else None)
    wl_view = SimpleNamespace(read_bytes=content["read_bytes"],
                              write_bytes=content["write_bytes"],
                              framework=content["framework"])
    rec = trace.flatten_trace(tr, wl_view)
    rec.pipeline = np.asarray(gids, np.int64)[rec.pipeline]
    return rec


def _sort_records(rec: trace.TaskRecords) -> trace.TaskRecords:
    """Rows in (pipeline, task_pos) order — retirement order varies with
    the windowing, the one-shot flattener's doesn't."""
    order = np.lexsort((rec.task_pos, rec.pipeline))
    cols = {f.name: (v[order] if (v := getattr(rec, f.name)) is not None
                     else None)
            for f in dataclasses.fields(trace.TaskRecords)}
    return trace.TaskRecords(**cols)


class _Ingest:
    """Pulls a window's rows from the ingestion buffer (the source's
    synthesis and the per-block failure draws) and uploads them: on a
    worker thread, and on the card on a side CUDA stream, while the
    previous window runs; or in line. Hands over ``(segments, row
    tensors)`` once joined."""

    def __init__(self, take, proto, has_asv, device, overlap):
        self.take, self.proto = take, proto
        self.has_asv, self.device = has_asv, device
        self.pool = ThreadPoolExecutor(max_workers=1) if overlap else None
        self.side = (torch.cuda.Stream(device) if overlap
                     and device.type == "cuda" else None)

    def _pull(self, bound):
        segs = self.take(bound)
        rows = (_row_tensors(_merge(self.proto, segs), self.has_asv,
                             self.device) if segs else None)
        return segs, rows

    def _stage(self, bound):
        if self.side is None:
            return self._pull(bound) + (None,)
        # the side stream starts after what the card was given so far (the
        # parameters the synthesis reads), not after the window's waves
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            segs, rows = self._pull(bound)
            ev = torch.cuda.Event()
            ev.record(self.side)
        return segs, rows, ev

    def start(self, bound):
        """Begin staging the rows up to ``bound``; returns the call that
        hands them over (:meth:`join` it)."""
        if self.pool is None:
            return lambda: self._stage(bound)
        return self.pool.submit(self._stage, bound).result

    def join(self, staged):
        segs, rows, ev = staged
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for v in (rows or {}).values():
                v.record_stream(cur)
        return segs, rows

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True)


def stream_simulate(
        source: TraceSource,
        platform: Optional[M.PlatformConfig] = None,
        *,
        policy: int = POLICY_FIFO,
        scenario=None,
        fleet=None,
        trigger=None,
        probe=None,
        horizon_s: float = 7 * 86400.0,
        window_s: Optional[float] = None,
        seed: int = 0,
        params=None,
        max_blocks: Optional[int] = None,
        overlap: bool = True,
        min_rows: int = 64,
        admission_sort: str = "kernel",
        sink: Optional[Callable[[trace.TaskRecords], None]] = None,
        plan_out: Optional[list] = None,
        device=None) -> StreamResult:
    """Stream a :class:`TraceSource` through the batched engine on
    ``device`` (``None``: the card) in arrival windows of ``window_s``
    (default ``horizon_s / 8``), bit-identical to materializing the whole
    stream into one ``simulate_ensemble`` call (:func:`oneshot_reference`).

    ``horizon_s`` bounds the *operational* grids (capacity schedule,
    controller / trigger / probe ticks), exactly as on the one-shot path —
    the task stream itself may run past it (``max_blocks`` bounds an
    unbounded source; ``sink`` consumes each retired window's
    :class:`TaskRecords` so nothing accumulates). ``overlap=False`` runs
    ingestion after each window instead of beside it. ``plan_out`` (a list)
    receives the internal plan for white-box tests."""
    t_wall = time.perf_counter()
    dev = resolve_device(device)
    plan = _StreamPlan(platform, policy, scenario, fleet, trigger, probe,
                       horizon_s, seed, params, admission_sort, dev)
    if plan_out is not None:
        plan_out.append(plan)
    window_s = float(window_s if window_s is not None else horizon_s / 8.0)
    if window_s <= 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")

    ingest_s = [0.0]
    wm = WorkloadManager(source, on_block=plan.on_block(0))

    def take(bound):
        t0 = time.perf_counter()
        if max_blocks is not None and wm.n_blocks >= max_blocks:
            wm.stop()
        segs = wm.take_until(bound)
        ingest_s[0] += time.perf_counter() - t0
        return segs

    # ---- window 0 ingest (the fleet pool compiles off the first block)
    first = take(np.float32(window_s))
    cf, pool = None, None
    if fleet is not None:
        t0 = time.perf_counter()
        cf, pool = plan.compile_fleet(next(iter(source.blocks())))
        ingest_s[0] += time.perf_counter() - t0
    P = cf.n_pool if cf is not None else 0

    from repro_torch.core.workload import MAX_TASKS
    T = (first[0]["task_type"].shape[1] if first
         else (pool["task_type"].shape[1] if pool is not None else MAX_TASKS))
    if not first and pool is None and wm.exhausted:
        raise ValueError(f"source {source.name!r} yielded no rows")
    proto = _empty_buf(T, plan.a_stat, plan.has_asv)
    buf = _merge(proto, first)

    # ---- the constant inputs, on the device from window 0: schedule,
    # backoff, controller, fleet and probe tensors, the pool block's rows
    one_row = plan.scenario_kwargs(
        np.ones((1, T), np.int64),
        np.zeros((1, T, plan.a_stat)) if plan.has_asv else None,
        np.zeros((1, T)), 1)
    const = {k: v for k, v in one_row.items()
             if k not in ("attempts", "attempt_service")}
    if cf is not None:
        const.update(stack_fleets([cf], n_max=0))
        const.pop("pool_base")
    if plan.probe is not None:
        const.update(stack_probes([plan.probe], [cf]))
        const.pop("n_probe_slots", None)
    const = to_tensors(const, dev)
    const["capacities"] = torch.as_tensor(
        np.asarray(plan.caps, np.int32)[None], device=dev)
    pool_rows = (_row_tensors(pool, plan.has_asv, dev)
                 if pool is not None else None)
    statics = plan.statics()

    recs: List[trace.TaskRecords] = []
    n_rows_emitted = [0]

    def emit(rec: trace.TaskRecords):
        n_rows_emitted[0] += int(rec.pipeline.shape[0])
        (sink if sink is not None else recs.append)(rec)

    ingest = _Ingest(take, proto, plan.has_asv, dev, overlap)
    new_rows = (_row_tensors(buf, plan.has_asv, dev)
                if buf["gid"].shape[0] else None)
    W = 0
    k = 0
    peak_live = 0
    waves = 0
    rows = None                  # the last window's per-row inputs
    st = None                    # the last window's carry (on the device)
    keep_idx = None              # retained-row indices into the last layout
    prev_pool_off = 0
    try:
        while True:
            n_exo = int(buf["gid"].shape[0])
            peak_live = max(peak_live, n_exo)
            last = wm.exhausted
            need = n_exo + P
            W = max(W, _bucket(need, min_rows))
            pads = W - need
            guard = (np.float32(CTRL_INF) if last
                     else np.float32((k + 1) * window_s))

            # ---- per-row inputs [1, W, ...]: [retained | new | pool | pad]
            keep_dev = (None if keep_idx is None else torch.as_tensor(
                keep_idx, dtype=torch.long, device=dev))
            parts = []
            if keep_dev is not None and keep_dev.numel():
                parts.append({k_: v[:, keep_dev] for k_, v in rows.items()})
            if new_rows is not None:
                parts.append(new_rows)
            if pool_rows is not None:
                parts.append(pool_rows)
            if pads:
                parts.append(_pad_rows(parts[0] if parts else _row_tensors(
                    proto, plan.has_asv, dev), pads))
            rows = {k_: torch.cat([p[k_] for p in parts], 1)
                    for k_ in parts[0]}
            inputs = dict(rows, **const)
            if cf is not None:
                inputs["pool_base"] = torch.tensor([n_exo], dtype=torch.int32,
                                                   device=dev)

            # ---- resume carry: retained rows + fresh rows + pool + pads
            if st is None:
                # the initial state from a zero-wave call; every window,
                # the first included, then resumes
                init = vdes.simulate_ensemble(
                    **inputs, policy=plan.policy, **statics,
                    wave_budget=torch.zeros(1, dtype=torch.int32, device=dev),
                    return_state=True, device=dev)
                resume = dict(init["state"])
                if pads:
                    resume["phase"] = resume["phase"].clone()
                    resume["phase"][:, need:] = _DONE
            else:
                n_new = 0 if new_rows is None else new_rows["arrival"].shape[1]
                resume = {}
                for key, v in st.items():
                    if key not in ROW_STATE_KEYS:
                        resume[key] = v
                        continue
                    cat = [v[:, keep_dev]]
                    if n_new:
                        cat.append(_fresh_rows(key, v, n_new,
                                               new_rows["arrival"]))
                    cat.append(v[:, prev_pool_off:prev_pool_off + P])
                    if pads:
                        cat.append(_fresh_rows(
                            key, v, pads, rows["arrival"][:, need:],
                            done=True))
                    resume[key] = torch.cat(cat, 1)

            # ---- window k+1's ingestion beside window k (overlap=True)
            staged = (ingest.start(np.float32((k + 2) * window_s))
                      if not last else None)
            res = vdes.simulate_ensemble(
                **inputs, policy=plan.policy, **statics, resume=resume,
                time_budget=torch.tensor([guard], dtype=torch.float32,
                                         device=dev),
                return_state=True, device=dev)
            st = res["state"]
            segs, new_rows = (ingest.join(staged()) if staged is not None
                              else ([], None))

            k += 1
            waves = int(st["wave"][0])
            exo_done = st["phase"][0, :n_exo].cpu().numpy() == _DONE
            if last:
                if n_exo:
                    emit(_extract_records(buf, st, np.arange(n_exo),
                                          buf["gid"], plan.caps))
                if P:
                    # pool pipeline ids follow ALL exogenous ids, as in the
                    # one-shot extended workload's layout
                    pool_gids = int(wm.n_rows) + np.arange(P)
                    emit(_extract_records(
                        pool, st, n_exo + np.arange(P), pool_gids, plan.caps,
                        arrival=st["pool_arr"][0].cpu().numpy().astype(
                            np.float64)))
                break

            retired = np.flatnonzero(exo_done)
            if retired.size:
                emit(_extract_records(_take(buf, retired), st, retired,
                                      buf["gid"][retired], plan.caps))
            keep_idx = np.flatnonzero(~exo_done)
            prev_pool_off = n_exo
            buf = _merge(_take(buf, keep_idx), segs)
    finally:
        ingest.close()

    # ---- result assembly --------------------------------------------------
    records = None
    summary: Dict = {}
    if sink is None and recs:
        records = _sort_records(trace.concat_records(recs))
        summary = trace.summarize(
            records, plan.caps, plan.horizon_s, schedule=plan.schedule,
            cost_rates=plan.platform.cost_rates,
            slo=plan.scenario.slo if plan.scenario is not None else None)

    def host(key):
        return st[key][0].cpu().numpy()

    ctrl_times = ctrl_caps = None
    if "ctrl_act" in st:
        ctrl_times, ctrl_caps = unpack_ctrl_actions(host("ctrl_act"),
                                                    int(host("ctrl_n")))
    fleet_cols = None
    if cf is not None and "fleet_perf" in st:
        ft, fk, fm = unpack_fleet_actions(host("fleet_act"),
                                          int(host("fleet_n")))
        fleet_cols = dict(
            fleet_perf=host("fleet_perf").astype(np.float64),
            fleet_stale=host("fleet_stale").astype(np.float64),
            fleet_ticks=np.asarray(cf.tick_times, np.float64),
            fleet_times=ft, fleet_kind=fk, fleet_model=fm,
            pool_arr=host("pool_arr").astype(np.float64),
            pool_model=host("pool_model").astype(np.int64))
    probe_times = probe_vals = None
    if plan.probe is not None and "probe_vals" in st:
        probe_times = np.asarray(plan.probe.times, np.float64)
        probe_vals = host("probe_vals")[:plan.probe.n_ticks].astype(
            np.float64)

    wall = time.perf_counter() - t_wall
    summary.update(n_windows=k, n_blocks=wm.n_blocks, waves=waves,
                   peak_rows=W, wall_s=wall)
    return StreamResult(
        records=records, summary=summary, n_windows=k, n_blocks=wm.n_blocks,
        n_pipelines=wm.n_rows, n_task_rows=n_rows_emitted[0], waves=waves,
        peak_rows=W, peak_live=peak_live + P, wall_s=wall,
        ingest_s=ingest_s[0], ctrl_times=ctrl_times, ctrl_caps=ctrl_caps,
        fleet_cols=fleet_cols, probe_times=probe_times,
        probe_vals=probe_vals)


# ---------------------------------------------------------------------------
# one-shot reference (the parity oracle)
# ---------------------------------------------------------------------------

def oneshot_reference(
        source: TraceSource,
        platform: Optional[M.PlatformConfig] = None,
        *,
        policy: int = POLICY_FIFO,
        scenario=None, fleet=None, trigger=None, probe=None,
        horizon_s: float = 7 * 86400.0, seed: int = 0, params=None,
        max_blocks: Optional[int] = None,
        admission_sort: str = "kernel", device=None) -> Dict:
    """Materialize the ENTIRE stream — identical per-block draws to the
    windowed driver — into one ``vdes.simulate_ensemble`` call on
    ``device`` (``None``: the card). Returns the sorted records plus the
    operational timelines, keyed like :class:`StreamResult` (plus
    ``wall_s`` for the fixed-horizon baseline wall and ``workload`` for
    inspection)."""
    from repro_torch.core.runtime import _concat_workloads

    t0 = time.perf_counter()
    dev = resolve_device(device)
    plan = _StreamPlan(platform, policy, scenario, fleet, trigger, probe,
                       horizon_s, seed, params, admission_sort, dev)
    wls, atts, asvs = [], [], []
    for b, wl in enumerate(source.blocks()):
        if max_blocks is not None and b >= max_blocks:
            break
        att, asv = plan.block_attempts(wl, b)
        wls.append(wl)
        atts.append(att)
        if plan.has_asv:
            asvs.append(np.asarray(asv, np.float64))
    exo = wls[0]
    for w in wls[1:]:
        exo = _concat_workloads(exo, w)

    cf = None
    wl_ext = exo
    if fleet is not None:
        from repro_torch.core.runtime import TriggerSpec
        from repro_torch.ops.scenario import compile_fleet
        trig = trigger if trigger is not None else TriggerSpec()
        cf, wl_ext = compile_fleet(fleet, trig, exo, plan.platform,
                                   plan.horizon_s, seed=plan.seed,
                                   params=params)
        if plan.scenario is not None:
            comp = plan.scenario.compile(
                _rows_workload(wl_ext, exo.n), plan.platform, plan.horizon_s,
                seed=_block_seed(plan.seed, _POOL_SALT), policy=plan.policy,
                schedule=plan.schedule, device=dev)
            atts.append(np.asarray(comp.attempts, np.int64))
            if plan.has_asv:
                asvs.append(np.asarray(comp.attempt_service, np.float64))
        else:
            atts.append(np.ones((wl_ext.n - exo.n, exo.max_tasks), np.int64))
            if plan.has_asv:
                asvs.append(np.repeat(np.asarray(
                    wl_ext.service_time(plan.platform.datastore),
                    np.float64)[exo.n:, :, None], plan.a_stat, -1))

    N = wl_ext.n
    svc = np.asarray(wl_ext.service_time(plan.platform.datastore),
                     np.float64)
    cols = dict(
        arrival=np.asarray(wl_ext.arrival, np.float64
                           ).astype(np.float32)[None],
        n_tasks=np.asarray(wl_ext.n_tasks, np.int32)[None],
        task_res=np.asarray(wl_ext.task_res, np.int32)[None],
        service=svc.astype(np.float32)[None],
        priority=np.asarray(wl_ext.priority, np.float32)[None])
    cols.update(plan.scenario_kwargs(
        np.concatenate(atts), np.concatenate(asvs) if plan.has_asv else None,
        svc, N))
    if cf is not None:
        cols.update(stack_fleets([cf], n_max=N))
    if plan.probe is not None:
        pkw = stack_probes([plan.probe], [cf])
        pkw.pop("n_probe_slots", None)
        cols.update(pkw)

    out = vdes.simulate_ensemble(
        **to_tensors(cols, dev),
        capacities=np.asarray(plan.caps, np.int32)[None], policy=plan.policy,
        **plan.statics(), device=dev)
    out = {k_: v.cpu() for k_, v in out.items()}
    tr = batch_trace(out, 0, wl_ext, plan.caps, with_scenario=True,
                     fleet=cf, probe=plan.probe)
    rec = trace.flatten_trace(tr, wl_ext)
    fleet_cols = None
    if cf is not None:
        fleet_cols = dict(
            fleet_perf=np.asarray(tr.fleet_perf, np.float64),
            fleet_stale=np.asarray(tr.fleet_stale, np.float64),
            fleet_ticks=np.asarray(cf.tick_times, np.float64),
            fleet_times=np.asarray(tr.fleet_times, np.float64),
            fleet_kind=np.asarray(tr.fleet_kind, np.int64),
            fleet_model=np.asarray(tr.fleet_model, np.int64),
            pool_arr=out["pool_arr"][0][:cf.n_pool].numpy().astype(
                np.float64),
            pool_model=out["pool_model"][0][:cf.n_pool].numpy().astype(
                np.int64))
    return dict(records=_sort_records(rec), trace=tr, workload=wl_ext,
                ctrl_times=tr.ctrl_times, ctrl_caps=tr.ctrl_caps,
                fleet_cols=fleet_cols,
                probe_times=(np.asarray(plan.probe.times, np.float64)
                             if plan.probe is not None else None),
                probe_vals=(np.asarray(tr.probe_vals, np.float64)
                            if plan.probe is not None else None),
                wall_s=time.perf_counter() - t0,
                summary=trace.summarize(
                    _sort_records(rec), plan.caps, plan.horizon_s,
                    schedule=plan.schedule,
                    cost_rates=plan.platform.cost_rates))


# ---------------------------------------------------------------------------
# parity metric
# ---------------------------------------------------------------------------

def _nan_drift(a, b) -> float:
    """Max |a - b| with NaN==NaN; shape mismatch or one-sided NaN = inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(a - b)
    d[both_nan] = 0.0
    if np.isnan(d).any():       # NaN on exactly one side
        return float("inf")
    return float(np.max(d))


def _pad_att(v: Optional[np.ndarray], width: int,
             n: int) -> Optional[np.ndarray]:
    if v is None:
        return np.full((n, width), np.nan)
    if v.shape[1] < width:
        v = np.pad(v, ((0, 0), (0, width - v.shape[1])),
                   constant_values=np.nan)
    return v


def parity_drift(sr: StreamResult, ref: Dict) -> float:
    """Max |streamed - oneshot| over every comparable tensor: the task
    records (timestamps, attempts, per-attempt windows), the realized
    controller timeline, the fleet drift/staleness/action tensors, and the
    probe matrix. 0.0 = bit parity. The wave counter is excluded by
    design (padding rows may run extra far-future waves on the one-shot
    path)."""
    a, b = sr.records, ref["records"]
    drift = 0.0
    if a.pipeline.shape != b.pipeline.shape:
        return float("inf")
    for f in ("pipeline", "task_pos", "task_type", "resource", "ready",
              "start", "finish", "read_bytes", "write_bytes", "framework",
              "attempts", "arrival", "pipeline_done"):
        drift = max(drift, _nan_drift(getattr(a, f), getattr(b, f)))
    wa = [v.shape[1] for v in (a.att_start, b.att_start) if v is not None]
    if wa:
        width, n = max(wa), a.pipeline.shape[0]
        for f in ("att_start", "att_finish"):
            drift = max(drift, _nan_drift(
                _pad_att(getattr(a, f), width, n),
                _pad_att(getattr(b, f), width, n)))
    for key in ("ctrl_times", "ctrl_caps", "probe_times", "probe_vals"):
        va, vb = getattr(sr, key), ref[key]
        if (va is None) != (vb is None):
            return float("inf")
        if va is not None:
            drift = max(drift, _nan_drift(va, vb))
    if (sr.fleet_cols is None) != (ref["fleet_cols"] is None):
        return float("inf")
    if sr.fleet_cols is not None:
        for key, va in sr.fleet_cols.items():
            drift = max(drift, _nan_drift(va, ref["fleet_cols"][key]))
    return drift
