"""Capacity schedules & composable capacity policies (operational scenarios).

Numpy copy of the schedule half of :mod:`repro.ops.capacity` for the
PyTorch port. A :class:`CapacitySchedule` is piecewise-constant
per-resource capacity over time; the batched engine indexes it as a
``[R, K, nres]`` tensor inside its wave loop. Policies produce schedules:

  - :class:`StaticCapacity`        — the seed behavior (K = 1);
  - :class:`MaintenanceWindows`    — calendar windows that drain part of a pool;
  - :class:`ScheduledAutoscaler`   — predictive scaling along the hour-of-week
    arrival profile (Fig 10).

The reference's ``ReactiveAutoscaler`` (planned from a baseline run) and
``ReactiveController`` (closed loop, in the control stage) arrive with the
controller slice of the port.

Node-outage injection (see :mod:`repro_torch.ops.failures`) composes onto
any policy schedule via :func:`apply_capacity_deltas`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


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
              workload=None, platform=None, policy: int = 0) -> CapacitySchedule:
        return static_schedule(base_caps)


@dataclasses.dataclass(frozen=True)
class MaintenanceWindows:
    """Calendar windows ``(t0_s, t1_s, resource, frac_remaining)`` during which
    a resource pool runs at ``round(cap * frac_remaining)`` nodes."""

    windows: Tuple[Tuple[float, float, int, float], ...] = ()

    def build(self, base_caps: np.ndarray, horizon_s: float, *,
              workload=None, platform=None, policy: int = 0) -> CapacitySchedule:
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
              workload=None, platform=None, policy: int = 0) -> CapacitySchedule:
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
