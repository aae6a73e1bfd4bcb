"""Cost & SLO accounting for operational scenarios.

Numpy copy of :mod:`repro.ops.accounting` for the PyTorch port. Folds into
:func:`repro_torch.core.trace.summarize` (via its ``schedule`` /
``cost_rates`` / ``slo`` kwargs): provisioned node-seconds and dollar cost
from the capacity schedule, busy node-seconds (failed attempts included),
utilization against *time-varying* provisioning, pipeline deadline-miss rate
and per-task wait-SLO violations.

Under closed-loop control the *planned* schedule is not what the platform
paid for: the engine records the controller's action timeline
(``SimTrace.ctrl_times``/``ctrl_caps``) and the reliability events
(``rel_times``/``rel_caps``), and :func:`realized_schedule` splices both onto
the planned schedule. :func:`lifecycle_summary` and
:func:`availability_summary` are the model-lifecycle and reliability blocks;
:class:`StreamAccumulator` folds a streamed run's window-partial records
into a summary without keeping them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import model as M
from repro_torch.core.des import unpack_controller
from repro_torch.ops.capacity import CapacitySchedule, normalize


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level objectives: a pipeline must complete within
    ``pipeline_deadline_s`` of its arrival, and no task should queue longer
    than ``task_wait_slo_s``."""

    pipeline_deadline_s: float = 4 * 3600.0
    task_wait_slo_s: float = 900.0


def _res_name(r: int) -> str:
    return M.RESOURCE_NAMES[r] if r < len(M.RESOURCE_NAMES) else f"res{r}"


def busy_node_seconds(rec, nres: int, horizon_s: float = np.inf) -> np.ndarray:
    """[nres] node-seconds actually occupied within ``[0, horizon_s)``.
    Contributions are clipped at the horizon — matching the provisioned
    integral, so utilization-vs-provisioned stays <= 1 even when backlog
    drains past the horizon.

    When the records carry per-attempt start/finish columns (``att_start``/
    ``att_finish``, recorded by the engines under scenarios), occupancy is
    summed over the *actual* attempt windows — exact even under heavy retry
    with resampled per-attempt durations. Without them the (attempts - 1)
    failed attempts are modeled as a back-to-back window ending at the final
    attempt's start (latest-possible placement, an in-horizon lower bound).
    Backoff gaps between attempts are idle and excluded either way."""
    if rec.att_start is not None and rec.att_finish is not None:
        s = np.nan_to_num(rec.att_start, nan=0.0)
        f = np.nan_to_num(rec.att_finish, nan=0.0)
        busy = np.clip(np.minimum(f, horizon_s) - np.clip(s, 0.0, None),
                       0.0, None).sum(1)
    else:
        start = np.nan_to_num(rec.start, nan=0.0)
        finish = np.nan_to_num(rec.finish, nan=0.0)
        dur = np.clip(finish - start, 0.0, None)
        final = np.clip(np.minimum(finish, horizon_s) - start, 0.0, None)
        prior_dur = (rec.attempts - 1) * dur
        prior = np.clip(np.minimum(start, horizon_s)
                        - np.clip(start - prior_dur, 0.0, None),
                        0.0, prior_dur)
        busy = final + prior
    out = np.zeros(nres)
    for r in range(nres):
        out[r] = busy[rec.resource == r].sum()
    return out


def capacity_cost(schedule: CapacitySchedule, horizon_s: float,
                  rates_per_node_hour: np.ndarray) -> Dict:
    """Dollar cost of the provisioned (not merely used) capacity."""
    node_s = schedule.provisioned_node_seconds(horizon_s)
    rates = np.asarray(rates_per_node_hour, np.float64)
    per_res = node_s / 3600.0 * rates
    return {
        "node_hours": {_res_name(r): float(node_s[r] / 3600.0)
                       for r in range(node_s.shape[0])},
        "cost": {_res_name(r): float(per_res[r])
                 for r in range(node_s.shape[0])},
        "total_cost": float(per_res.sum()),
    }


def pipeline_spans(rec) -> Dict[str, np.ndarray]:
    """Per-pipeline (arrival, completion, makespan) from flat task records.
    Uses the records' arrival column — NOT ready, which retry re-queues
    overwrite — so the deadline clock starts at the true arrival. A pipeline
    that never fully completes (NaN start/finish, or stranded mid-retry per
    the pipeline_done column) gets completion NaN and counts as a miss."""
    pids = np.asarray(rec.pipeline, np.int64)
    hi = int(pids.max()) + 1 if pids.size else 0
    t0 = np.full(hi, np.inf)
    t1 = np.full(hi, -np.inf)
    nan_mask = np.zeros(hi, bool)
    np.minimum.at(t0, pids, np.where(np.isnan(rec.arrival), np.inf,
                                     rec.arrival))
    np.maximum.at(t1, pids, np.where(np.isnan(rec.finish), -np.inf, rec.finish))
    np.logical_or.at(nan_mask, pids,
                     np.isnan(rec.finish) | ~np.asarray(rec.pipeline_done))
    present = np.zeros(hi, bool)
    present[pids] = True
    arrival = t0[present]
    complete = np.where(nan_mask[present], np.nan, t1[present])
    return {"pipeline": np.nonzero(present)[0], "arrival": arrival,
            "complete": complete, "makespan": complete - arrival}


def realized_schedule(tr, compiled) -> CapacitySchedule:
    """The capacity timeline the engines *actually* provisioned: the planned
    schedule overlaid with the controller's recorded action timeline AND
    the reliability stage's recorded outage/repair events.

    ``tr`` is the :class:`~repro_torch.core.model.SimTrace` (its ``ctrl_times`` /
    ``ctrl_caps`` columns are the engine-recorded controller actions, its
    ``rel_times`` / ``rel_caps`` columns the engine-recorded reliability
    events as *cumulative* per-resource deltas), ``compiled`` the
    :class:`~repro_torch.ops.scenario.CompiledScenario` that produced it. Both
    compose with the schedule as deltas (effective capacity = schedule(t) +
    ctrl_target(t) - base + rel_cum(t), exactly the engines' control
    stage), so the realized schedule is that sum clipped at 0. A zone
    outage therefore shows up as a capacity *dip* whose recovery edge is
    the repair crew's FIFO finish time — repair-delayed, not instantaneous.
    With no controller and no fired reliability events the *planned
    schedule object* is returned unchanged — existing summaries stay
    bit-identical.
    """
    sched = compiled.schedule
    ctrl = getattr(compiled, "controller", None)
    times = getattr(tr, "ctrl_times", None)
    has_ctrl = (ctrl is not None and times is not None
                and times.shape[0] > 0)
    rtimes = getattr(tr, "rel_times", None)
    has_rel = rtimes is not None and rtimes.shape[0] > 0
    if not has_ctrl and not has_rel:
        return sched
    cut_list = [sched.times]
    if has_ctrl:
        times = np.asarray(times, np.float64)
        cut_list.append(times)
    if has_rel:
        rtimes = np.asarray(rtimes, np.float64)
        cut_list.append(rtimes)
    cuts = np.unique(np.concatenate(cut_list))
    caps = sched.at(cuts).astype(np.int64)
    if has_ctrl:
        base = np.rint(np.asarray(unpack_controller(
            np.asarray(ctrl, np.float64))[9])).astype(np.int64)
        targets = np.asarray(tr.ctrl_caps, np.int64)
        # controller target in effect at each cut: the last action at or
        # before it, else the base (delta 0)
        idx = np.searchsorted(times, cuts, side="right") - 1
        tgt = np.where(idx[:, None] >= 0, targets[np.clip(idx, 0, None)],
                       base[None, :])
        caps = caps + tgt - base[None, :]
    if has_rel:
        rcum = np.asarray(tr.rel_caps, np.int64)
        ridx = np.searchsorted(rtimes, cuts, side="right") - 1
        caps = caps + np.where(ridx[:, None] >= 0,
                               rcum[np.clip(ridx, 0, None)], 0)
    return normalize(cuts, np.clip(caps, 0, None))


def lifecycle_summary(tr) -> Dict:
    """The model-lifecycle block :func:`repro_torch.core.trace.summarize` folds in
    (via its ``lifecycle`` kwarg). All the shared aggregates (staleness
    integral, trigger/redeploy counts, timelines) come from the ONE decoder
    — :func:`repro_torch.core.runtime.lifecycle_result` — so the summary block
    and ``ExperimentResult.lifecycle`` can never disagree; this adds only
    the scalar accounting view. ``staleness_integral_s`` is the mean over
    models of ``∫ staleness dt`` over the drift-evaluation tick grid (the
    grid's last tick is within one interval of the horizon by
    construction); ``retrain_node_seconds`` is the busy time of the
    activated retraining pipelines — what the trigger policy *spent*. With
    ``total_cost`` these span the cost-vs-staleness frontier a
    trigger-policy sweep traces out."""
    from repro_torch.core.runtime import lifecycle_result
    lc = lifecycle_result(tr)
    if lc is None:
        raise ValueError(
            "trace carries no fleet columns (the run had no FleetSpec); "
            "lifecycle_summary needs a trace from a model-lifecycle run")
    perf = lc.perf_timeline                       # [M, E]
    recorded = ~np.isnan(perf).all(0)
    last = int(np.nonzero(recorded)[0][-1]) if recorded.any() else -1
    return {
        "n_models": int(perf.shape[0]),
        "n_triggered": lc.n_triggered,
        "n_retrained": lc.n_retrained,
        "mean_staleness": lc.mean_staleness,
        "staleness_integral_s": lc.staleness_integral_s,
        "final_mean_performance": float(np.nanmean(perf[:, last]))
        if last >= 0 else float("nan"),
        "n_exogenous": lc.n_exogenous,
        "retrain_pool_size": int(tr.start.shape[0] - tr.fleet_pool_base),
        "retrain_node_seconds": float(np.clip(
            np.nan_to_num(tr.finish[tr.fleet_pool_base:], nan=0.0)
            - np.nan_to_num(tr.start[tr.fleet_pool_base:], nan=0.0),
            0.0, None).sum()),
    }


def availability_summary(rel, platform, tr=None) -> Dict:
    """The reliability block :func:`repro_torch.core.engines._summarize` folds
    into each replica's summary (``summary["availability"]``).

    ``rel`` is the replica's
    :class:`~repro_torch.reliability.CompiledReliability`. Downtime integrals
    come from the compiled event timeline itself (``times`` +
    ``cum_deltas`` — post-drain up events past the horizon contribute
    nothing, matching the engines, which never run past the horizon's
    drain); per-domain-kind node-seconds come from the host-side
    :class:`~repro_torch.reliability.RelEvent` records (overlap-clamped node
    counts). ``tr`` (the replica's SimTrace) adds eviction *resume*
    accounting: evicted pipelines whose tasks still completed.

    The spot-vs-on-demand cost split charges the nominal pools over the
    horizon at the platform's cost rates, with the spot slice discounted —
    the denominator a spot-fraction frontier trades against availability.
    """
    h = float(rel.horizon_s)
    base = np.asarray(rel.base_caps, np.float64)
    nres = base.shape[0]

    # ∫ nodes-down dt per resource, truncated at the horizon
    down_node_s = np.zeros(nres)
    if rel.n_events:
        ts = np.asarray(rel.times, np.float64)
        cum = rel.cum_deltas().astype(np.float64)          # [RV, R], <= 0
        dt = np.diff(np.concatenate([ts, [h]])).clip(0.0, None)
        down_node_s = (np.maximum(-cum, 0.0) * dt[:, None]).sum(0)
    denom = np.maximum(base * h, 1e-12)
    avail = 1.0 - down_node_s / denom

    by_kind: Dict = {}
    for ev in rel.events:
        d = by_kind.setdefault(ev.kind, {"n": 0, "node_seconds": 0.0})
        d["n"] += 1
        dur = max(0.0, min(ev.t_up, h) - min(ev.t_down, h))
        d["node_seconds"] += float(ev.nodes.sum()) * dur

    out: Dict = {
        "availability": {_res_name(r): float(avail[r])
                         for r in range(nres)},
        "downtime_node_seconds": {_res_name(r): float(down_node_s[r])
                                  for r in range(nres)},
        "n_events": rel.n_events,
        "by_kind": by_kind,
        "repair": {
            "n_repairs": int(rel.repair_waits.shape[0]),
            "mean_wait_s": float(rel.repair_waits.mean())
            if rel.repair_waits.size else 0.0,
            "max_wait_s": float(rel.repair_waits.max())
            if rel.repair_waits.size else 0.0,
            "queue_depth_max": rel.repair_depth_max,
            "n_stragglers": rel.n_straggler_repairs,
        },
    }
    rates = np.asarray(platform.cost_rates, np.float64)[:nres]
    spot = np.asarray(rel.spot_nodes, np.float64)
    od = base - spot
    spot_cost = float((spot * rates).sum() * h / 3600.0 * rel.discount)
    out["cost_split"] = {
        "on_demand_cost": float((od * rates).sum() * h / 3600.0),
        "spot_cost": spot_cost,
        "spot_discount": float(rel.discount),
        "spot_savings": float((spot * rates).sum() * h / 3600.0
                              * (1.0 - rel.discount)),
    }
    if rel.evict_attempts is not None:
        ev = np.asarray(rel.evict_attempts, np.int64)
        hit = ev.sum(1) > 0                      # pipelines with evictions
        evb: Dict = {"evicted_tasks": int(ev.sum()),
                     "evicted_pipelines": int(hit.sum())}
        done = getattr(tr, "completed", None) if tr is not None else None
        if done is not None:
            done = np.asarray(done, bool)[: hit.shape[0]]
            evb["resumed_pipelines"] = int((hit & done).sum())
        out["eviction"] = evb
    return out


def slo_metrics(rec, slo: SLOConfig,
                deadlines: Optional[np.ndarray] = None) -> Dict:
    """Deadline-miss and wait-SLO violation rates. ``deadlines`` optionally
    gives a per-pipeline deadline (indexed by pipeline id) overriding the
    global ``slo.pipeline_deadline_s``; a never-finishing pipeline counts as
    a miss.

    The wait-SLO rate is over tasks that actually ran (``attempts >= 1``,
    the same mask :func:`scenario_summary` uses): a stranded task has NaN
    wait, which ``NaN <= x -> False`` would otherwise silently count as a
    violation — stranding is reported via ``stranded_task_frac``, not here.
    """
    spans = pipeline_spans(rec)
    if deadlines is not None:
        dl = np.asarray(deadlines, np.float64)[spans["pipeline"]]
    else:
        dl = np.full(spans["pipeline"].shape, slo.pipeline_deadline_s)
    ok = spans["makespan"] <= dl          # NaN makespan -> False -> miss
    ran = np.asarray(rec.attempts) >= 1
    wait = rec.wait[ran]
    wait_ok = wait <= slo.task_wait_slo_s
    finite_ms = spans["makespan"][np.isfinite(spans["makespan"])]
    return {
        "n_pipelines": int(spans["pipeline"].shape[0]),
        "deadline_miss_rate": float(1.0 - np.mean(ok)) if ok.size else 0.0,
        "mean_makespan_s": float(np.mean(finite_ms)) if finite_ms.size
        else float("nan"),
        "wait_slo_violation_rate": float(1.0 - np.mean(wait_ok))
        if wait.size else 0.0,
    }


def scenario_summary(rec, schedule: CapacitySchedule, horizon_s: float,
                     cost_rates: Optional[np.ndarray] = None,
                     slo: Optional[SLOConfig] = None,
                     deadlines: Optional[np.ndarray] = None,
                     planned: Optional[CapacitySchedule] = None) -> Dict:
    """The cost/SLO block :func:`repro_torch.core.trace.summarize` folds in.

    ``schedule`` is the capacity timeline to charge for: under closed-loop
    control the *realized* one (see :func:`realized_schedule`). Pass the
    planning-time schedule as ``planned`` to additionally report
    ``planned_node_seconds`` and (with ``cost_rates``) ``planned_total_cost``
    plus the ``realized_vs_planned_cost_delta``."""
    nres = schedule.caps.shape[1]
    prov = schedule.provisioned_node_seconds(horizon_s)
    busy = busy_node_seconds(rec, nres, horizon_s)
    ran = np.asarray(rec.attempts) >= 1
    out: Dict = {
        "provisioned_node_seconds": {_res_name(r): float(prov[r])
                                     for r in range(nres)},
        "utilization_vs_provisioned": {
            _res_name(r): float(busy[r] / prov[r]) if prov[r] > 0 else 0.0
            for r in range(nres)},
        # over tasks that actually ran, so stranded tasks (attempts == 0)
        # don't masquerade as clean single-attempt runs
        "mean_attempts": float(np.mean(rec.attempts[ran])) if ran.any()
        else 0.0,
        "stranded_task_frac": float(np.mean(~ran)),
    }
    if cost_rates is not None:
        out.update(capacity_cost(schedule, horizon_s, cost_rates))
    if planned is not None:
        pprov = planned.provisioned_node_seconds(horizon_s)
        out["planned_node_seconds"] = {_res_name(r): float(pprov[r])
                                       for r in range(nres)}
        if cost_rates is not None:
            pcost = capacity_cost(planned, horizon_s, cost_rates)
            out["planned_total_cost"] = pcost["total_cost"]
            out["realized_vs_planned_cost_delta"] = float(
                out["total_cost"] - pcost["total_cost"])
    if slo is not None:
        out.update(slo_metrics(rec, slo, deadlines))
    return out


# ---------------------------------------------------------------------------
# windowed aggregation (streaming runs)
# ---------------------------------------------------------------------------

class StreamAccumulator:
    """Folds window-partial :class:`~repro_torch.core.trace.TaskRecords`
    batches into one summary without retaining the records — the accounting
    half of an unbounded :func:`repro_torch.stream.stream_simulate` run
    (pass ``sink=acc.add``).

    Batches must partition the stream by pipeline (each pipeline's records
    arrive in exactly one batch) — which is how the streaming driver
    retires pipelines, so ``n_pipelines``/deadline accounting stay exact.
    Sums (task/pipeline counts, mean wait, busy node-seconds, utilization,
    attempt and SLO-violation counts) are exact; wait *percentiles* come
    from a fixed log-spaced histogram (geometric bin-midpoint, resolution
    ~0.6% of the value with the default 4096 bins) since exact quantiles
    need the full wait vector the sink exists to avoid.
    """

    def __init__(self, capacities, horizon_s: float,
                 slo: Optional[SLOConfig] = None, n_bins: int = 4096,
                 wait_floor_s: float = 1e-3):
        self.caps = np.asarray(capacities, np.float64)
        self.horizon_s = float(horizon_s)
        self.slo = slo
        # bin 0: wait <= floor (incl. exact zero); log-spaced above
        self.edges = np.concatenate([
            [0.0], np.geomspace(wait_floor_s, max(horizon_s, wait_floor_s * 2),
                                n_bins)])
        self.hist = np.zeros(n_bins + 1, np.int64)
        self.n_tasks = 0
        self.n_pipelines = 0
        self.n_batches = 0
        self.wait_sum = 0.0
        self.wait_n = 0
        self.busy = np.zeros(self.caps.shape[0])
        self.attempts_sum = 0
        self.ran_n = 0
        self.wait_viol = 0
        self.deadline_miss = 0
        self.type_wait_sum = np.zeros(M.N_TASK_TYPES)
        self.type_wait_n = np.zeros(M.N_TASK_TYPES, np.int64)

    def add(self, rec) -> None:
        self.n_batches += 1
        self.n_tasks += int(rec.start.shape[0])
        self.n_pipelines += int(np.unique(rec.pipeline).shape[0])
        wait = np.asarray(rec.wait, np.float64)
        ok = ~np.isnan(wait)
        w = wait[ok]
        self.wait_sum += float(w.sum())
        self.wait_n += int(w.shape[0])
        self.hist += np.bincount(
            np.clip(np.searchsorted(self.edges, w, side="right") - 1,
                    0, self.hist.shape[0] - 1),
            minlength=self.hist.shape[0])
        tt = np.asarray(rec.task_type)[ok]
        np.add.at(self.type_wait_sum, tt, w)
        np.add.at(self.type_wait_n, tt, 1)
        self.busy += busy_node_seconds(rec, self.caps.shape[0],
                                       self.horizon_s)
        ran = np.asarray(rec.attempts) >= 1
        self.ran_n += int(ran.sum())
        self.attempts_sum += int(np.asarray(rec.attempts)[ran].sum())
        if self.slo is not None:
            self.wait_viol += int((w > self.slo.task_wait_slo_s).sum())
            spans = pipeline_spans(rec)
            dl = self.slo.pipeline_deadline_s
            self.deadline_miss += int(
                (~(spans["makespan"] <= dl)).sum())   # NaN -> miss

    def _quantile(self, q: float) -> float:
        if self.wait_n == 0:
            return float("nan")
        cum = np.cumsum(self.hist)
        # the bin holding numpy's lower interpolation point at this rank
        b = int(np.searchsorted(cum, q * (self.wait_n - 1), side="right"))
        if b == 0:
            return 0.0
        lo, hi = self.edges[b], (self.edges[b + 1]
                                 if b + 1 < self.edges.shape[0]
                                 else self.edges[b])
        return float(np.sqrt(lo * hi)) if lo > 0 else float(hi)

    def summary(self) -> Dict:
        """Keys mirror :func:`repro_torch.core.trace.summarize` where the
        aggregation is well-defined windowwise."""
        denom = np.maximum(self.caps * self.horizon_s, 1e-12)
        out: Dict = {
            "n_tasks": self.n_tasks,
            "n_pipelines": self.n_pipelines,
            "n_batches": self.n_batches,
            "mean_wait_s": (self.wait_sum / self.wait_n) if self.wait_n
            else float("nan"),
            "p50_wait_s": self._quantile(0.50),
            "p95_wait_s": self._quantile(0.95),
            "p99_wait_s": self._quantile(0.99),
            "utilization": {_res_name(r): float(self.busy[r] / denom[r])
                            for r in range(self.caps.shape[0])},
            "mean_attempts": (self.attempts_sum / self.ran_n) if self.ran_n
            else 0.0,
            "stranded_task_frac": (1.0 - self.ran_n / self.n_tasks)
            if self.n_tasks else 0.0,
        }
        for t in range(M.N_TASK_TYPES):
            if self.type_wait_n[t]:
                out[f"wait_{M.TASK_TYPE_NAMES[t]}_s"] = float(
                    self.type_wait_sum[t] / self.type_wait_n[t])
        if self.slo is not None:
            out["wait_slo_violation_rate"] = (
                self.wait_viol / self.wait_n if self.wait_n else 0.0)
            out["deadline_miss_rate"] = (
                self.deadline_miss / self.n_pipelines
                if self.n_pipelines else 0.0)
        return out
