"""Conceptual system model (paper §IV-A): pipelines, tasks, resources, assets.

Numpy-only copy of :mod:`repro.core.model` for the PyTorch port. A workload
of N pipelines with at most T tasks each is a set of ``[N]`` / ``[N, T]``
arrays; the engine turns them into tensors on the device
(:mod:`repro_torch.core.batching`). :class:`SimTrace` carries the columns
every engine stage produces, the controller's, reliability's, fleet's and
probe's included, and the shared action timeline that reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Task types tau (paper: {preprocess, train, evaluate, compress, harden, ...})
# ---------------------------------------------------------------------------
PREPROCESS, TRAIN, EVALUATE, COMPRESS, HARDEN, DEPLOY = range(6)
TASK_TYPE_NAMES = ["preprocess", "train", "evaluate", "compress", "harden", "deploy"]
N_TASK_TYPES = len(TASK_TYPE_NAMES)

# Frameworks F with the paper's observed production mix (§IV-B.1).
SPARKML, TENSORFLOW, PYTORCH, CAFFE, OTHERFW = range(5)
FRAMEWORK_NAMES = ["sparkml", "tensorflow", "pytorch", "caffe", "other"]
FRAMEWORK_MIX = np.array([0.63, 0.32, 0.03, 0.01, 0.01])
N_FRAMEWORKS = len(FRAMEWORK_NAMES)

# Resources (paper §IV-A.1b: generic data storage + training + compute infra).
RES_COMPUTE, RES_TRAINING, RES_DATASTORE = range(3)
RESOURCE_NAMES = ["compute_cluster", "learning_cluster", "datastore"]

# Default task-type -> resource routing (Fig 11: preprocess on the compute
# cluster; train/compress/harden on the learning cluster; evaluate/deploy on
# the compute cluster).
DEFAULT_ROUTING = {
    PREPROCESS: RES_COMPUTE,
    TRAIN: RES_TRAINING,
    EVALUATE: RES_COMPUTE,
    COMPRESS: RES_TRAINING,
    HARDEN: RES_TRAINING,
    DEPLOY: RES_COMPUTE,
}


@dataclasses.dataclass(frozen=True)
class ResourceConfig:
    """A capacity-constrained infrastructure component (SimPy shared-resource
    semantics: FIFO queue, ``capacity`` concurrent jobs). ``cost_per_node_hour``
    feeds the operational cost accounting in :mod:`repro_torch.ops.accounting`."""

    name: str
    capacity: int
    cost_per_node_hour: float = 1.0


@dataclasses.dataclass(frozen=True)
class DataStoreConfig:
    """Data store abstracted as read/write ops (paper: S3-like). Transfers are
    delay components of the holding task: t = latency + bytes / bandwidth."""

    read_bandwidth: float = 400e6   # bytes/s per transfer stream
    write_bandwidth: float = 250e6
    latency: float = 0.15           # s per op


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """The modeled system: resources, routing, data store."""

    resources: Sequence[ResourceConfig] = (
        ResourceConfig("compute_cluster", 48),
        ResourceConfig("learning_cluster", 32),
    )
    routing: Dict[int, int] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ROUTING))
    datastore: DataStoreConfig = DataStoreConfig()

    @property
    def capacities(self) -> np.ndarray:
        return np.array([r.capacity for r in self.resources], np.int64)

    @property
    def cost_rates(self) -> np.ndarray:
        """[R] $ per node-hour (operational cost accounting)."""
        return np.array([r.cost_per_node_hour for r in self.resources],
                        np.float64)

    def route(self, task_type: np.ndarray) -> np.ndarray:
        table = np.zeros(N_TASK_TYPES, np.int64)
        for t, r in self.routing.items():
            table[t] = r
        return table[task_type]

    def resource_index(self, resource) -> int:
        """Resolve a resource by name or integer index."""
        if isinstance(resource, (int, np.integer)):
            if not 0 <= int(resource) < len(self.resources):
                raise IndexError(f"resource index {resource} out of range")
            return int(resource)
        for i, r in enumerate(self.resources):
            if r.name == resource:
                return i
        raise KeyError(f"no resource named {resource!r} in "
                       f"{[r.name for r in self.resources]}")

    def with_capacity(self, resource, capacity: int) -> "PlatformConfig":
        """A copy with one resource's capacity replaced — the sweep-axis
        primitive for platforms with arbitrarily many resources."""
        i = self.resource_index(resource)
        res = tuple(dataclasses.replace(r, capacity=int(capacity))
                    if j == i else r for j, r in enumerate(self.resources))
        return dataclasses.replace(self, resources=res)


@dataclasses.dataclass
class Workload:
    """A fully materialized stochastic trace: N pipelines x <= T tasks.

    Durations are *exec* times; ``read_bytes``/``write_bytes`` become data
    store delay components via :class:`DataStoreConfig`. ``service`` is the
    resource-holding time  t(read)+t(exec)+t(write)  (paper §IV-A.1d: a task
    executor is (read, exec..., write) while holding the compute resource;
    t(req) is the queueing wait the simulation resolves).
    """

    arrival: np.ndarray        # [N] f64 seconds since sim start
    n_tasks: np.ndarray        # [N] i32
    task_type: np.ndarray      # [N, T] i32 (padded with -1)
    task_res: np.ndarray       # [N, T] i32 resource index (padded 0)
    exec_time: np.ndarray      # [N, T] f64 seconds
    read_bytes: np.ndarray     # [N, T] f64
    write_bytes: np.ndarray    # [N, T] f64
    framework: np.ndarray      # [N] i32
    priority: np.ndarray       # [N] f32 (higher = served first for PRIORITY)
    # latent model asset properties materialized at train time (§V-B.b)
    model_perf: np.ndarray     # [N] f32  (e.g. AUC)
    model_size: np.ndarray     # [N] f32  bytes
    model_clever: np.ndarray   # [N] f32  robustness score

    @property
    def n(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def max_tasks(self) -> int:
        return int(self.task_type.shape[1])

    def service_time(self, ds: DataStoreConfig) -> np.ndarray:
        """[N, T] total resource-holding time per task."""
        io = np.zeros_like(self.exec_time)
        has_read = self.read_bytes > 0
        has_write = self.write_bytes > 0
        io += has_read * (ds.latency + self.read_bytes / ds.read_bandwidth)
        io += has_write * (ds.latency + self.write_bytes / ds.write_bandwidth)
        return self.exec_time + io

    def validate(self) -> None:
        n, t = self.task_type.shape
        assert self.arrival.shape == (n,)
        assert (self.n_tasks >= 1).all() and (self.n_tasks <= t).all()
        idx = np.arange(t)[None, :]
        live = idx < self.n_tasks[:, None]
        assert (self.task_type[live] >= 0).all()
        assert (self.exec_time[live] >= 0).all()
        # train must precede evaluate/compress/harden within each pipeline
        for bad_after in (EVALUATE, COMPRESS, HARDEN):
            first_train = _first_pos(self.task_type, TRAIN, self.n_tasks)
            pos_bad = _first_pos(self.task_type, bad_after, self.n_tasks)
            mask = pos_bad >= 0
            assert ((first_train[mask] >= 0) & (first_train[mask] < pos_bad[mask])).all(), (
                f"{TASK_TYPE_NAMES[bad_after]} precedes train")


def _first_pos(task_type: np.ndarray, t: int, n_tasks: np.ndarray) -> np.ndarray:
    n, T = task_type.shape
    idx = np.arange(T)[None, :]
    live = idx < n_tasks[:, None]
    hit = (task_type == t) & live
    pos = np.where(hit.any(1), hit.argmax(1), -1)
    return pos


@dataclasses.dataclass
class SimTrace:
    """Simulation output: per-task start/finish plus queueing detail."""

    start: np.ndarray        # [N, T] f64 service start (resource acquired)
    finish: np.ndarray       # [N, T] f64 service end (resource released)
    ready: np.ndarray        # [N, T] f64 when the task requested the resource
    n_tasks: np.ndarray      # [N]
    task_res: np.ndarray     # [N, T]
    task_type: np.ndarray    # [N, T]
    arrival: np.ndarray      # [N]
    capacities: np.ndarray   # [R] (initial capacities under a schedule)
    # service attempts actually executed per task (failure/retry scenarios);
    # None = every task ran exactly once
    attempts: Optional[np.ndarray] = None
    # [N] bool: pipeline ran ALL its tasks to successful completion. A task
    # stranded mid-retry still has a recorded (failed-attempt) finish, so
    # NaN-scanning cannot detect it; None = derive from NaNs (pre-scenario)
    completed: Optional[np.ndarray] = None
    # [N, T, A] per-attempt service start/finish (failure/retry scenarios;
    # NaN where the attempt never ran) — exact utilization/cost accounting
    # under heavy retry instead of the duration*attempts approximation
    att_start: Optional[np.ndarray] = None
    att_finish: Optional[np.ndarray] = None
    # realized capacity timeline under closed-loop control: ctrl_times [E]
    # action times and ctrl_caps [E, R] the integer per-resource targets the
    # controller set at those instants (engine-recorded, identical to the
    # reference engines'). None when the run had no enabled controller;
    # empty arrays when a controller ran but never acted.
    # ops.accounting.realized_schedule splices this onto the planned
    # schedule so provisioned cost/utilization integrate what the engine
    # actually provisioned
    ctrl_times: Optional[np.ndarray] = None
    ctrl_caps: Optional[np.ndarray] = None
    # reliability event timeline: rel_times [E] the fired outage / repair /
    # eviction event times and rel_caps [E, R] the integer *cumulative*
    # per-resource reliability capacity delta after each event
    # (engine-recorded, identical to the reference engines'; <= 0 while
    # domains are down). None when the run had no compiled reliability scenario; empty
    # arrays when one was enabled but no event fired before the run
    # drained. ops.accounting.realized_schedule splices this onto the
    # planned schedule alongside the controller timeline.
    rel_times: Optional[np.ndarray] = None
    rel_caps: Optional[np.ndarray] = None
    # model-lifecycle (fleet) stage outputs. fleet_perf/fleet_stale [E, M]:
    # true per-model performance / staleness at each drift-evaluation tick
    # (fleet_ticks [E]); fleet_times/fleet_kind/fleet_model [A]: the
    # engine-recorded lifecycle action timeline (kind 0 = trigger fired and
    # activated a retraining pipeline, 1 = retraining completed and
    # redeployed the model). None when the run had no fleet.
    # fleet_pool_base is the row index of the first (latent) retraining-pool
    # pipeline in the extended workload — rows before it are exogenous.
    fleet_perf: Optional[np.ndarray] = None
    fleet_stale: Optional[np.ndarray] = None
    fleet_ticks: Optional[np.ndarray] = None
    fleet_times: Optional[np.ndarray] = None
    fleet_kind: Optional[np.ndarray] = None
    fleet_model: Optional[np.ndarray] = None
    fleet_pool_base: Optional[int] = None
    # in-loop telemetry probe outputs: probe_times [E] f64 the compile-time
    # probe tick grid, probe_vals [E, K] f64 the engine-sampled channels
    # (K = core.des.probe_channel_count(nres); see obs.probes for the
    # channel layout and named-timeline view). Sampled in f32 as the
    # reference engines sample them; NaN rows are ticks the run never
    # reached. None when the run had no probe.
    probe_times: Optional[np.ndarray] = None
    probe_vals: Optional[np.ndarray] = None
    # engine wave-loop iteration count; the engines retire events in
    # identical waves, so tests assert *wave-for-wave* parity with this
    waves: Optional[int] = None

    def action_timeline(self):
        """The SHARED in-engine action timeline: every discrete action an
        in-engine actor took, time-sorted. Reliability events appear as
        ``("outage", t, cumulative_delta_vector)`` (any outage / repair /
        eviction capacity move); controller capacity moves as
        ``("scale", t, target_vector)``; model-lifecycle actions as
        ``("trigger", t, model_id)`` / ``("redeploy", t, model_id)``. Ties
        keep reliability events first, then controller actions (the order
        the control stage applies them within a wave)."""
        rows = []
        if self.rel_times is not None:
            for t, caps in zip(self.rel_times, self.rel_caps):
                rows.append((float(t), -1, ("outage", float(t), caps)))
        if self.ctrl_times is not None:
            for t, caps in zip(self.ctrl_times, self.ctrl_caps):
                rows.append((float(t), 0, ("scale", float(t), caps)))
        if self.fleet_times is not None:
            names = {0: "trigger", 1: "redeploy"}
            for t, k, m in zip(self.fleet_times, self.fleet_kind,
                               self.fleet_model):
                rows.append((float(t), 1,
                             (names[int(k)], float(t), int(m))))
        rows.sort(key=lambda r: (r[0], r[1]))
        return [r[2] for r in rows]

    @property
    def wait(self) -> np.ndarray:
        """[N, T] queueing wait t(req(R)) per task."""
        return self.start - self.ready

    @property
    def pipeline_makespan(self) -> np.ndarray:
        n = self.n_tasks
        last = np.take_along_axis(self.finish, (n - 1)[:, None], axis=1)[:, 0]
        return last - self.arrival

    @property
    def pipeline_wait(self) -> np.ndarray:
        idx = np.arange(self.start.shape[1])[None, :]
        live = idx < self.n_tasks[:, None]
        return np.where(live, self.wait, 0.0).sum(1)
