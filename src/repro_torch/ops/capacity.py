"""Capacity schedules & composable capacity policies (operational scenarios).

Numpy copy of the schedule half of :mod:`repro.ops.capacity` for the
PyTorch port. A :class:`CapacitySchedule` is piecewise-constant
per-resource capacity over time; the batched engine indexes it as a
``[R, K, nres]`` tensor inside its wave loop. Policies produce schedules:

  - :class:`StaticCapacity`        — the seed behavior (K = 1);
  - :class:`MaintenanceWindows`    — calendar windows that drain part of a pool;
  - :class:`ScheduledAutoscaler`   — predictive scaling along the hour-of-week
    arrival profile (Fig 10);
  - :class:`ReactiveAutoscaler`    — queue-length-driven scaling planned from a
    baseline simulation of the same workload (open-loop approximation of a
    closed-loop autoscaler; iterate ``n_iters`` for a fixed point). The
    port plans with its own engine, on the caller's device.

:class:`ReactiveController` is the *closed-loop* counterpart: it does not
produce a schedule at all. It compiles to a flat ``[C]`` ControllerParams
tensor that the engine evaluates **inside** its wave loop, reacting to live
queue lengths (capacity = schedule baseline + controller delta). Controller
tensors batch per replica (``[R, C]``) through
:func:`repro_torch.core.batching.stack_scenarios`.

Node-outage injection (see :mod:`repro_torch.ops.failures`) composes onto
any policy schedule via :func:`apply_capacity_deltas`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.des import (CTRL_COOLDOWN, CTRL_FIELDS, CTRL_HEADER,
                                  CTRL_INF, CTRL_INTERVAL, CTRL_T_END,
                                  CTRL_T_FIRST)


@dataclasses.dataclass(frozen=True)
class CapacitySchedule:
    """Piecewise-constant capacity: ``caps[k]`` holds on ``[times[k], times[k+1])``.

    Invariants (enforced by :func:`normalize`): ``times[0] == 0``, times
    strictly increasing, ``caps >= 0`` integer.
    """

    times: np.ndarray   # [K] f64
    caps: np.ndarray    # [K, nres] i64

    @property
    def n_changes(self) -> int:
        return int(self.times.shape[0])

    def at(self, t) -> np.ndarray:
        """Capacity vector(s) in effect at time(s) ``t``."""
        idx = np.clip(np.searchsorted(self.times, t, side="right") - 1,
                      0, self.n_changes - 1)
        return self.caps[idx]

    def padded(self, n_changes: int, horizon_s: float) -> "CapacitySchedule":
        """Pad to exactly ``n_changes`` change points with no-op changes past
        the horizon — batched grid points must share the ``[K, nres]`` tensor
        shape, and a change point after every finish time is semantically
        inert in both engines."""
        pad = n_changes - self.n_changes
        if pad <= 0:
            return self
        times = np.concatenate(
            [self.times, self.times[-1] + horizon_s + 1.0 + np.arange(pad)])
        caps = np.concatenate([self.caps, np.tile(self.caps[-1:], (pad, 1))])
        return CapacitySchedule(times=times, caps=caps)

    def provisioned_node_seconds(self, horizon_s: float) -> np.ndarray:
        """[nres] integral of capacity over [0, horizon_s)."""
        edges = np.concatenate([self.times, [max(horizon_s, self.times[-1])]])
        widths = np.clip(np.minimum(edges[1:], horizon_s)
                         - np.minimum(edges[:-1], horizon_s), 0.0, None)
        return (self.caps * widths[:, None]).sum(0).astype(np.float64)


def normalize(times: np.ndarray, caps: np.ndarray) -> CapacitySchedule:
    """Sort, dedupe (last value wins), force a t=0 anchor, clip caps >= 0."""
    times = np.asarray(times, np.float64)
    caps = np.asarray(np.rint(caps), np.int64)
    order = np.argsort(times, kind="stable")
    times, caps = times[order], caps[order]
    # last entry wins for duplicate timestamps
    keep = np.concatenate([times[1:] != times[:-1], [True]])
    times, caps = times[keep], caps[keep]
    if times.shape[0] == 0 or times[0] > 0.0:
        raise ValueError("capacity schedule must start at t=0")
    # drop no-op change points (identical consecutive capacity rows)
    if times.shape[0] > 1:
        change = np.concatenate([[True], (caps[1:] != caps[:-1]).any(1)])
        times, caps = times[change], caps[change]
    return CapacitySchedule(times=times, caps=np.clip(caps, 0, None))


def static_schedule(base_caps: np.ndarray) -> CapacitySchedule:
    return CapacitySchedule(times=np.zeros(1, np.float64),
                            caps=np.asarray(base_caps, np.int64)[None, :].copy())


def apply_capacity_deltas(sched: CapacitySchedule,
                          deltas: Sequence[Tuple[float, float, int, int]],
                          ) -> CapacitySchedule:
    """Overlay interval deltas ``(t0, t1, resource, delta_nodes)`` — e.g. node
    outages (negative) or burst pools (positive) — onto a policy schedule."""
    if not deltas:
        return sched
    cuts = set(sched.times.tolist())
    for t0, t1, _, _ in deltas:
        cuts.add(float(max(t0, 0.0)))
        cuts.add(float(max(t1, 0.0)))
    times = np.array(sorted(cuts), np.float64)
    caps = sched.at(times).copy()
    for t0, t1, r, d in deltas:
        active = (times >= t0) & (times < t1)
        caps[active, int(r)] += int(d)
    return normalize(times, caps)


# ---------------------------------------------------------------------------
# Policies. Each builds a schedule from the base platform capacities.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaticCapacity:
    """K = 1: the platform's configured capacities, unchanged over time."""

    def build(self, base_caps: np.ndarray, horizon_s: float, *,
              workload=None, platform=None, policy: int = 0,
              device=None) -> CapacitySchedule:
        return static_schedule(base_caps)


@dataclasses.dataclass(frozen=True)
class MaintenanceWindows:
    """Calendar windows ``(t0_s, t1_s, resource, frac_remaining)`` during which
    a resource pool runs at ``round(cap * frac_remaining)`` nodes."""

    windows: Tuple[Tuple[float, float, int, float], ...] = ()

    def build(self, base_caps: np.ndarray, horizon_s: float, *,
              workload=None, platform=None, policy: int = 0,
              device=None) -> CapacitySchedule:
        base_caps = np.asarray(base_caps, np.int64)
        deltas = []
        for t0, t1, r, frac in self.windows:
            lost = int(base_caps[int(r)] - round(base_caps[int(r)] * frac))
            deltas.append((float(t0), float(t1), int(r), -lost))
        return apply_capacity_deltas(static_schedule(base_caps), deltas)


@dataclasses.dataclass(frozen=True)
class ScheduledAutoscaler:
    """Predictive scaling: capacity follows the hour-of-week arrival profile
    (Fig 10), linearly mapped into ``[min_scale, max_scale] * base``."""

    min_scale: float = 0.5
    max_scale: float = 1.25
    resources: Optional[Tuple[int, ...]] = None   # None = scale every pool
    interval_s: float = 3600.0

    def build(self, base_caps: np.ndarray, horizon_s: float, *,
              workload=None, platform=None, policy: int = 0,
              device=None) -> CapacitySchedule:
        from repro_torch.core.workload import hour_of_week_weights
        base_caps = np.asarray(base_caps, np.int64)
        w = hour_of_week_weights()
        span = w.max() - w.min()
        if span > 0:
            scale = self.min_scale + (self.max_scale - self.min_scale) * (
                (w - w.min()) / span)
        else:
            scale = np.ones_like(w)   # flat profile: keep base capacity
        n_slots = int(np.ceil(horizon_s / self.interval_s))
        times = np.arange(n_slots) * self.interval_s
        how = (times // 3600.0).astype(np.int64) % 168
        caps = np.tile(base_caps[None], (n_slots, 1)).astype(np.float64)
        which = range(base_caps.shape[0]) if self.resources is None \
            else self.resources
        for r in which:
            caps[:, int(r)] = np.maximum(
                np.rint(base_caps[int(r)] * scale[how]), 1.0)
        return normalize(times, caps)


@dataclasses.dataclass(frozen=True)
class ReactiveAutoscaler:
    """Queue-length autoscaler planned from a baseline run of the workload:
    intervals whose mean queue-per-slot exceeds ``high_watermark`` scale the
    pool up by ``step``; below ``low_watermark`` scale down. ``n_iters > 1``
    re-simulates under the planned schedule to approach the closed-loop
    fixed point. The baseline runs are the port's own single-replica
    :func:`repro_torch.core.vdes.simulate_to_trace` on ``device`` (``None``:
    the card); on integer-time workloads the plan equals the reference's,
    which plans with its numpy engine."""

    high_watermark: float = 0.5    # waiting jobs per provisioned slot
    low_watermark: float = 0.05
    step: float = 0.25             # multiplicative scale step per interval
    min_scale: float = 0.5
    max_scale: float = 2.0
    interval_s: float = 3600.0
    resources: Optional[Tuple[int, ...]] = None
    n_iters: int = 1

    def build(self, base_caps: np.ndarray, horizon_s: float, *,
              workload=None, platform=None, policy: int = 0,
              device=None) -> CapacitySchedule:
        if workload is None or platform is None:
            raise ValueError(
                "ReactiveAutoscaler needs the full-horizon workload and "
                "platform to plan from a baseline simulation; pass them to "
                "Scenario.compile")
        from repro_torch.core import trace as trace_mod
        from repro_torch.core import vdes
        from repro_torch.ops.scenario import CompiledScenario

        base_caps = np.asarray(base_caps, np.int64)
        nres = base_caps.shape[0]
        sched = static_schedule(base_caps)
        for it in range(max(1, self.n_iters)):
            compiled = None if it == 0 and sched.n_changes == 1 else \
                CompiledScenario(schedule=sched,
                                 attempts=np.ones(workload.task_type.shape,
                                                  np.int64))
            tr = vdes.simulate_to_trace(workload, platform, policy,
                                        scenario=compiled, device=device)
            rec = trace_mod.flatten_trace(tr, workload)
            q = trace_mod.queue_length_timeline(
                rec, nres, bin_s=self.interval_s, horizon_s=horizon_s)["qlen"]
            sched = self._plan(base_caps, q)
        return sched

    def _plan(self, base_caps: np.ndarray, qlen: np.ndarray) -> CapacitySchedule:
        nres, nbins = qlen.shape
        which = set(range(nres)) if self.resources is None \
            else set(int(r) for r in self.resources)
        cap = base_caps.astype(np.float64).copy()
        caps = np.zeros((nbins, nres))
        for b in range(nbins):
            for r in range(nres):
                if r in which:
                    per_slot = qlen[r, b] / max(cap[r], 1.0)
                    if per_slot > self.high_watermark:
                        cap[r] = min(cap[r] * (1.0 + self.step),
                                     base_caps[r] * self.max_scale)
                    elif per_slot < self.low_watermark:
                        cap[r] = max(cap[r] * (1.0 - self.step),
                                     base_caps[r] * self.min_scale)
                    caps[b, r] = max(round(cap[r]), 1)
                else:
                    # uncontrolled pools keep their base capacity verbatim:
                    # the >= 1 floor is a liveness guard for scaled pools
                    # only and must not resurrect a zero-capacity pool
                    caps[b, r] = base_caps[r]
        times = np.arange(nbins) * self.interval_s
        return normalize(times, caps)


# ---------------------------------------------------------------------------
# Closed-loop control: compiled to a flat tensor the engine evaluates inside
# its wave loop (no schedule, no planning pass).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReactiveController:
    """Closed-loop queue-reactive controller evaluated INSIDE the engine.

    Every ``interval_s`` it observes the live queued-jobs-per-effective-slot
    ratio of each resource and scales its continuous capacity state by
    ``1 +- step`` when the ratio crosses ``high_watermark`` /
    ``low_watermark``, clamped to ``[min_scale, max_scale] * base``. The
    rounded integer target composes with the capacity schedule as a delta
    (effective capacity = schedule(t) + target - base). Any movement of the
    continuous state starts the ``cooldown_s`` window during which
    evaluations are suppressed.

    ``compile`` materializes the flat ``[C]`` ControllerParams tensor
    (``C = CTRL_HEADER + CTRL_FIELDS * nres``; layout in
    :mod:`repro_torch.core.des`). Evaluation ticks run from ``interval_s`` to
    the compile horizon; the finite grid keeps the wave loop bounded even
    when a scale-to-zero controller stalls the queue.
    """

    high_watermark: float = 0.5    # waiting jobs per effective slot
    low_watermark: float = 0.05
    step: float = 0.25             # multiplicative scale step per action
    min_scale: float = 0.5
    max_scale: float = 2.0
    interval_s: float = 3600.0
    cooldown_s: float = 0.0
    resources: Optional[Tuple[int, ...]] = None   # None = control every pool

    @property
    def name(self) -> str:
        """Label for sweep-axis point names: every field that can
        distinguish two gain settings (defaults elided)."""
        parts = [f"hw={self.high_watermark:g}", f"lw={self.low_watermark:g}",
                 f"step={self.step:g}",
                 f"sc={self.min_scale:g}-{self.max_scale:g}",
                 f"iv={self.interval_s:g}"]
        if self.cooldown_s:
            parts.append(f"cd={self.cooldown_s:g}")
        if self.resources is not None:
            parts.append("res=" + "+".join(str(r) for r in self.resources))
        return "ctrl(" + ",".join(parts) + ")"

    def compile(self, base_caps: np.ndarray, horizon_s: float) -> np.ndarray:
        """The ``[C]`` f32 ControllerParams tensor for ``base_caps``.
        Uncontrolled resources get unreachable watermarks and a zero step,
        so their delta stays 0 forever."""
        if self.interval_s <= 0:
            raise ValueError("ReactiveController.interval_s must be > 0")
        # the engine advances the tick grid in f32; an interval below the
        # clock ulp at the horizon could never advance
        if np.float32(horizon_s) + np.float32(self.interval_s) \
                <= np.float32(horizon_s):
            raise ValueError(
                f"interval_s={self.interval_s} is below the f32 clock ulp "
                f"({np.spacing(np.float32(horizon_s))}) at horizon "
                f"{horizon_s}; evaluation ticks could not advance")
        base = np.asarray(base_caps, np.float64)
        nres = base.shape[0]
        out = np.zeros(CTRL_HEADER + CTRL_FIELDS * nres, np.float32)
        out[CTRL_INTERVAL] = self.interval_s
        out[CTRL_COOLDOWN] = self.cooldown_s
        out[CTRL_T_FIRST] = self.interval_s   # first evaluation tick
        out[CTRL_T_END] = horizon_s           # last evaluation tick
        which = set(range(nres)) if self.resources is None \
            else {int(r) for r in self.resources}
        for r in range(nres):
            o = CTRL_HEADER + CTRL_FIELDS * r
            if r in which:
                out[o:o + CTRL_FIELDS] = (
                    self.high_watermark, self.low_watermark, self.step,
                    base[r] * self.min_scale, base[r] * self.max_scale,
                    base[r])
            else:
                out[o:o + CTRL_FIELDS] = (CTRL_INF, -CTRL_INF, 0.0,
                                          base[r], base[r], base[r])
        return out


def disabled_controller(nres: int) -> np.ndarray:
    """An all-zero ``[C]`` row: the engine treats interval <= 0 as 'no
    controller', the inert padding row of a batch."""
    return np.zeros(CTRL_HEADER + CTRL_FIELDS * int(nres), np.float32)
