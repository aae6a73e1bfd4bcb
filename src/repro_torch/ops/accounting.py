"""Cost & SLO accounting for operational scenarios.

Numpy copy of the planned-schedule half of :mod:`repro.ops.accounting` for
the PyTorch port. Folds into :func:`repro_torch.core.trace.summarize` (via
its ``schedule`` / ``cost_rates`` / ``slo`` kwargs): provisioned
node-seconds and dollar cost from the capacity schedule, busy node-seconds
(failed attempts included), utilization against *time-varying*
provisioning, pipeline deadline-miss rate and per-task wait-SLO violations.
The realized-schedule, lifecycle, availability and streaming blocks of the
reference arrive with the controller, fleet, reliability and streaming
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import model as M
from repro_torch.ops.capacity import CapacitySchedule


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
                     deadlines: Optional[np.ndarray] = None) -> Dict:
    """The cost/SLO block :func:`repro_torch.core.trace.summarize` folds in,
    charged against the planned capacity ``schedule``."""
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
    if slo is not None:
        out.update(slo_metrics(rec, slo, deadlines))
    return out
