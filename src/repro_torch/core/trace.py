"""Columnar trace store + analytics (the paper's InfluxDB/Grafana role).

Numpy copy of :mod:`repro.core.trace` for the PyTorch port: flat per-task
records from a :class:`~repro_torch.core.model.SimTrace` and the dashboard
metrics (Fig 10/11) computed from them — utilization over time, queue
lengths, task wait times, arrivals per hour of the week, network traffic —
plus the cost/SLO summary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import model as M


@dataclasses.dataclass
class TaskRecords:
    """Flat per-task event records (one row per executed task)."""

    pipeline: np.ndarray   # [E] i64
    task_pos: np.ndarray   # [E]
    task_type: np.ndarray  # [E]
    resource: np.ndarray   # [E]
    ready: np.ndarray      # [E] f64
    start: np.ndarray      # [E]
    finish: np.ndarray     # [E]
    read_bytes: np.ndarray
    write_bytes: np.ndarray
    framework: np.ndarray
    # service attempts per task (failure/retry scenarios); defaults to 1
    attempts: Optional[np.ndarray] = None
    # the owning pipeline's arrival time (retry re-queues overwrite ready, so
    # SLO makespans must not be derived from it); falls back to ready
    arrival: Optional[np.ndarray] = None
    # whether the owning pipeline ran to full completion (a task stranded
    # mid-retry records its failed attempt's finish, so NaNs can't tell);
    # falls back to finish being non-NaN
    pipeline_done: Optional[np.ndarray] = None
    # [E, A] per-attempt start/finish times (failure/retry scenarios; NaN
    # where the attempt never ran). None for runs without retries —
    # accounting then uses the duration*attempts approximation
    att_start: Optional[np.ndarray] = None
    att_finish: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.attempts is None:
            self.attempts = np.ones_like(self.start, np.int64)
        if self.arrival is None:
            self.arrival = np.asarray(self.ready, np.float64).copy()
        if self.pipeline_done is None:
            self.pipeline_done = ~np.isnan(self.finish)

    @property
    def wait(self) -> np.ndarray:
        return self.start - self.ready

    @property
    def duration(self) -> np.ndarray:
        return self.finish - self.start

    def save(self, path: str) -> None:
        cols = {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}
        np.savez_compressed(path, **cols)

    @staticmethod
    def load(path: str) -> "TaskRecords":
        z = np.load(path)
        return TaskRecords(**{k: z[k] for k in z.files})


def flatten_trace(trace: M.SimTrace, wl: M.Workload) -> TaskRecords:
    n, T = trace.start.shape
    idx = np.arange(T)[None, :]
    live = idx < trace.n_tasks[:, None]
    # rows with a non-finite arrival never entered the platform and must
    # not appear in records/summaries
    live &= np.isfinite(np.asarray(trace.arrival, np.float64))[:, None]
    pid, pos = np.nonzero(live)
    return TaskRecords(
        pipeline=pid, task_pos=pos,
        task_type=trace.task_type[pid, pos],
        resource=trace.task_res[pid, pos],
        ready=trace.ready[pid, pos],
        start=trace.start[pid, pos],
        finish=trace.finish[pid, pos],
        read_bytes=wl.read_bytes[pid, pos],
        write_bytes=wl.write_bytes[pid, pos],
        framework=wl.framework[pid],
        # raw executed counts: 0 = never admitted (stranded), kept so
        # accounting can tell stranding apart from a clean 1-attempt run
        attempts=None if trace.attempts is None
        else np.asarray(trace.attempts[pid, pos], np.int64),
        arrival=np.asarray(trace.arrival, np.float64)[pid],
        pipeline_done=None if trace.completed is None
        else np.asarray(trace.completed, bool)[pid],
        att_start=None if trace.att_start is None
        else np.asarray(trace.att_start, np.float64)[pid, pos],
        att_finish=None if trace.att_finish is None
        else np.asarray(trace.att_finish, np.float64)[pid, pos],
    )


def concat_records(recs) -> TaskRecords:
    """Concatenate record batches *exactly*. The per-attempt columns may be
    absent or have different attempt-slot widths across batches: attempt
    ``k`` always occupies slot ``k``, so right-padding narrower batches with
    NaN is positionally exact. A batch *without* the columns still executed
    every started task as one attempt over ``(start, finish)`` — those rows
    contribute that exact interval in slot 0 (NaN only where the task never
    started), so concatenated batches are charged as each batch alone.
    Accepts any iterable (materialized once)."""
    recs = list(recs)
    fields = [f.name for f in dataclasses.fields(TaskRecords)]
    out = {}
    for f in fields:
        vals = [getattr(r, f) for r in recs]
        if f in ("att_start", "att_finish"):
            if all(v is None for v in vals):
                out[f] = None
                continue
            width = max(v.shape[1] for v in vals if v is not None)
            cols = []
            for r, v in zip(recs, vals):
                if v is None:
                    # exact single-attempt interval, not an all-NaN row
                    v = np.full((r.start.shape[0], width), np.nan)
                    src = r.start if f == "att_start" else r.finish
                    v[:, 0] = np.asarray(src, np.float64)
                elif v.shape[1] < width:
                    v = np.pad(v, ((0, 0), (0, width - v.shape[1])),
                               constant_values=np.nan)
                cols.append(v)
            out[f] = np.concatenate(cols) if cols else None
        else:
            out[f] = np.concatenate(vals)
    return TaskRecords(**out)


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------

def _provisioned_bins(schedule, capacities: np.ndarray,
                      edges: np.ndarray) -> np.ndarray:
    """[nres, nbins] provisioned node-seconds per bin: the integral of the
    (possibly time-varying) capacity schedule over each bin, or
    ``capacities * bin`` when no schedule is given."""
    if schedule is None:
        widths = np.diff(edges)
        return np.asarray(capacities, np.float64)[:, None] * widths[None, :]
    cum = np.stack([schedule.provisioned_node_seconds(float(t))
                    for t in edges])                       # [nbins+1, nres]
    return np.diff(cum, axis=0).T


def utilization_timeline(rec: TaskRecords, capacities: np.ndarray,
                         bin_s: float = 3600.0,
                         horizon_s: Optional[float] = None,
                         schedule=None) -> Dict[str, np.ndarray]:
    """Busy-server integral per resource per time bin / provisioned
    node-seconds in the bin. ``schedule`` (a
    :class:`~repro_torch.ops.capacity.CapacitySchedule`) supplies a
    time-varying denominator; without it the denominator is
    ``capacities * bin_s``. Bins with zero provisioned capacity report 0."""
    horizon = horizon_s or float(np.nanmax(rec.finish)) + 1.0
    nbins = int(np.ceil(horizon / bin_s))
    nres = capacities.shape[0]
    util = np.zeros((nres, nbins))
    edges = np.arange(nbins + 1) * bin_s
    if schedule is None:
        prov = np.broadcast_to(
            np.asarray(capacities, np.float64)[:, None] * bin_s,
            (nres, nbins))
    else:
        prov = _provisioned_bins(schedule, capacities, edges)
    ran = ~np.isnan(rec.start)    # stranded tasks (scenario starvation) idle
    for r in range(nres):
        m = (rec.resource == r) & ran
        s, f = rec.start[m], rec.finish[m]
        for b in range(nbins):
            if prov[r, b] <= 0.0:
                continue
            lo, hi = edges[b], edges[b + 1]
            overlap = np.clip(np.minimum(f, hi) - np.maximum(s, lo), 0.0, None)
            util[r, b] = overlap.sum() / prov[r, b]
    return {"edges": edges, "util": util}


def mean_utilization(rec: TaskRecords, capacities: np.ndarray,
                     horizon_s: float, schedule=None) -> np.ndarray:
    """Busy node-seconds / provisioned node-seconds per resource.
    ``schedule`` as in :func:`utilization_timeline`."""
    nres = capacities.shape[0]
    out = np.zeros(nres)
    prov = _provisioned_bins(schedule, capacities,
                             np.array([0.0, horizon_s]))[:, 0]
    ran = ~np.isnan(rec.start)    # stranded tasks (scenario starvation) idle
    for r in range(nres):
        if prov[r] <= 0:          # inert pool (e.g. ragged-grid padding)
            continue
        m = (rec.resource == r) & ran
        busy = np.clip(np.minimum(rec.finish[m], horizon_s) - rec.start[m],
                       0.0, None).sum()
        out[r] = busy / prov[r]
    return out


def queue_length_timeline(rec: TaskRecords, nres: int, bin_s: float = 3600.0,
                          horizon_s: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Time-averaged number of waiting jobs per resource per bin."""
    horizon = horizon_s or float(np.nanmax(rec.finish)) + 1.0
    nbins = int(np.ceil(horizon / bin_s))
    q = np.zeros((nres, nbins))
    edges = np.arange(nbins + 1) * bin_s
    requested = ~np.isnan(rec.ready)
    for r in range(nres):
        m = (rec.resource == r) & requested
        # a stranded task (requested, never admitted) waits forever
        a = rec.ready[m]
        s = np.where(np.isnan(rec.start[m]), np.inf, rec.start[m])
        for b in range(nbins):
            lo, hi = edges[b], edges[b + 1]
            overlap = np.clip(np.minimum(s, hi) - np.maximum(a, lo), 0.0, None)
            q[r, b] = overlap.sum() / bin_s
    return {"edges": edges, "qlen": q}


def arrivals_per_hour(arrival_s: np.ndarray) -> np.ndarray:
    """[7, 24] mean arrivals per hour-of-week slot (Fig 10)."""
    hrs = (arrival_s // 3600.0).astype(np.int64)
    how = hrs % 168
    n_weeks = max(1.0, (arrival_s.max() - arrival_s.min()) / (168 * 3600.0))
    counts = np.bincount(how, minlength=168).astype(np.float64) / n_weeks
    return counts.reshape(7, 24)


def network_traffic(rec: TaskRecords, bin_s: float = 3600.0,
                    horizon_s: Optional[float] = None,
                    tcp_overhead: float = 1.05) -> Dict[str, np.ndarray]:
    """Bytes moved to/from the data store per bin (dashboard panel; the paper
    notes its traffic figure 'includes TCP overhead')."""
    horizon = horizon_s or float(np.nanmax(rec.finish)) + 1.0
    nbins = int(np.ceil(horizon / bin_s))
    edges = np.arange(nbins + 1) * bin_s
    ran = ~np.isnan(rec.start)    # stranded tasks never transfer
    b = np.clip((rec.start[ran] // bin_s).astype(np.int64), 0, nbins - 1)
    rd = np.bincount(b, weights=rec.read_bytes[ran],
                     minlength=nbins) * tcp_overhead
    wr = np.bincount(b, weights=rec.write_bytes[ran],
                     minlength=nbins) * tcp_overhead
    return {"edges": edges, "read": rd, "write": wr}


def summarize(rec: TaskRecords, capacities: np.ndarray, horizon_s: float,
              schedule=None, cost_rates: Optional[np.ndarray] = None,
              slo=None, deadlines: Optional[np.ndarray] = None,
              realized=None, lifecycle=None) -> Dict:
    """Dashboard summary. The optional operational-scenario kwargs fold in
    cost/SLO accounting: ``schedule`` (a :class:`repro_torch.ops.capacity.
    CapacitySchedule`) adds a ``utilization_vs_provisioned`` block computed
    against the time-varying provisioning (the plain ``utilization`` key
    stays relative to the static ``capacities`` argument) and, with
    ``cost_rates`` ($/node-hour), dollar cost; ``slo`` (a
    :class:`repro_torch.ops.accounting.SLOConfig`) adds deadline-miss and
    wait-SLO metrics (``deadlines`` optionally per-pipeline, indexed by
    pipeline id).

    ``realized`` (a second schedule, normally from
    :func:`repro_torch.ops.accounting.realized_schedule`) is the
    engine-recorded capacity timeline under closed-loop control and
    reliability events: when given, cost/utilization integrate *it* instead
    of the planned ``schedule`` (the top-level ``utilization`` included), and
    the planned figures come back alongside as ``planned_node_seconds`` /
    ``planned_total_cost`` / ``realized_vs_planned_cost_delta``.

    ``lifecycle`` (a dict from
    :func:`repro_torch.ops.accounting.lifecycle_summary`) folds the
    model-lifecycle block in, with ``mean_staleness`` / ``n_retrained`` /
    ``n_triggered`` / ``staleness_integral_s`` mirrored at the top level."""
    util = mean_utilization(rec, capacities, horizon_s, schedule=realized)
    out = {
        "n_tasks": int(rec.start.shape[0]),
        "n_pipelines": int(np.unique(rec.pipeline).shape[0]),
        "mean_wait_s": float(np.nanmean(rec.wait)),
        "p50_wait_s": float(np.nanpercentile(rec.wait, 50)),
        "p95_wait_s": float(np.nanpercentile(rec.wait, 95)),
        "p99_wait_s": float(np.nanpercentile(rec.wait, 99)),
        "utilization": {M.RESOURCE_NAMES[r] if r < len(M.RESOURCE_NAMES) else f"res{r}":
                        float(util[r]) for r in range(capacities.shape[0])},
    }
    for t in range(M.N_TASK_TYPES):
        m = rec.task_type == t
        if m.any():
            out[f"wait_{M.TASK_TYPE_NAMES[t]}_s"] = float(np.nanmean(rec.wait[m]))
    if schedule is not None or slo is not None or realized is not None:
        from repro_torch.ops import accounting
        from repro_torch.ops.capacity import static_schedule
        sched = schedule if schedule is not None \
            else static_schedule(capacities)
        out.update(accounting.scenario_summary(
            rec, realized if realized is not None else sched, horizon_s,
            cost_rates=cost_rates, slo=slo, deadlines=deadlines,
            planned=sched if realized is not None else None))
    if lifecycle is not None:
        out["lifecycle"] = dict(lifecycle)
        for k in ("mean_staleness", "n_retrained", "n_triggered",
                  "staleness_integral_s"):
            out[k] = lifecycle[k]
    return out
