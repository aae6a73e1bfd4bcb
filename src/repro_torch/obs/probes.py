"""In-loop telemetry probes: declarative spec -> compiled tick grid -> named
timelines (a copy of :mod:`repro.obs.probes`).

A :class:`ProbeSpec` on an
:class:`~repro_torch.core.experiment.ExperimentSpec` asks the engine to
sample its own live state while simulating: the instantaneous queue depth a
:class:`~repro_torch.ops.capacity.ReactiveController` reacted to, or the
effective capacity mid-scale, which post-hoc records cannot reach.

:func:`compile_probe` walks the shared f32 tick-grid machinery
(:func:`repro_torch.core.des.fleet_tick_grid`), so the compile-time
``times [E]`` line up one-to-one with the instants the engine's probe stage
fires at. The engine fills a preallocated ``[E, K]`` f32 buffer, bit for bit
the reference engines' values, surfaced on
:class:`~repro_torch.core.model.SimTrace` as ``probe_times`` /
``probe_vals`` and wrapped here as a :class:`ProbeTimeline` with named
channels.

Channel layout (K = ``probe_channel_count(nres)`` = ``5*nres + 3``):

  ====================  ====================================================
  ``qlen:<res>``        jobs queued on the resource (post-admission)
  ``busy:<res>``        occupied slots = effective capacity - free
  ``cap:<res>``         effective capacity = schedule + controller delta
                        + reliability delta
  ``ctrl_delta:<res>``  controller delta vs the schedule baseline (0 open
                        loop)
  ``rel_delta:<res>``   cumulative reliability delta (outages/evictions
                        negative, repairs restoring; 0 without a
                        ReliabilitySpec)
  ``fleet_min_perf``    minimum live model performance across the fleet
  ``fleet_max_staleness``  maximum staleness across the fleet
  ``live_pipelines``    queued + running pipelines
  ====================  ====================================================

The fleet channels are min/max on purpose: order-independent reductions stay
bit-equal under any reduction order. They are NaN for runs without a
:class:`~repro_torch.core.runtime.FleetSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import model as M
from repro_torch.core.des import (PROBE_FIELDS, PROBE_INTERVAL,
                                  PROBE_N_MODELS, PROBE_T_END, PROBE_T_FIRST,
                                  fleet_tick_grid, probe_channel_count)


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Declarative in-loop telemetry: sample engine state every
    ``interval_s`` seconds starting at ``t_first`` (defaults to one interval
    in, mirroring ``TriggerSpec``). Inert data — :func:`compile_probe`
    lowers it onto the engines' f32 tick grid."""

    interval_s: float = 900.0
    t_first: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class CompiledProbe:
    """A probe lowered for the engines: the flat f32 ``header``
    (``[PROBE_FIELDS]`` = interval / t_first / t_end / n_models — what the
    probe stages consume) plus the f64 values of the f32 tick grid
    (``times [E]``, the buffer's row coordinates)."""

    header: np.ndarray   # [PROBE_FIELDS] f32
    times: np.ndarray    # [E] f64

    @property
    def n_ticks(self) -> int:
        return int(self.times.shape[0])


def compile_probe(spec: ProbeSpec, horizon_s: float,
                  n_models: int = 0) -> CompiledProbe:
    """Lower a :class:`ProbeSpec` onto the f32 tick grid over
    ``[t_first, horizon_s]``. ``n_models`` (the fleet's model count, 0
    without a fleet) rides in the header so the batched engine can mask
    its fleet min/max reductions to the entry's own unpadded model rows."""
    if spec.interval_s <= 0.0:
        raise ValueError(f"probe interval_s must be > 0, "
                         f"got {spec.interval_s}")
    t_first = spec.t_first if spec.t_first is not None else spec.interval_s
    times = fleet_tick_grid(spec.interval_s, t_first, horizon_s)
    if times.shape[0] == 0:
        raise ValueError(
            f"probe grid is empty: t_first={t_first} is past the horizon "
            f"{horizon_s}")
    header = np.zeros(PROBE_FIELDS, np.float32)
    header[PROBE_INTERVAL] = spec.interval_s
    header[PROBE_T_FIRST] = t_first
    header[PROBE_T_END] = horizon_s
    header[PROBE_N_MODELS] = n_models
    return CompiledProbe(header=header, times=times)


def probe_channel_names(resource_names: Sequence[str]) -> List[str]:
    """The ``[K]`` channel names for a platform's resources, in buffer
    order (see the module docstring for the layout)."""
    names = []
    for prefix in ("qlen", "busy", "cap", "ctrl_delta", "rel_delta"):
        names.extend(f"{prefix}:{r}" for r in resource_names)
    names.extend(["fleet_min_perf", "fleet_max_staleness",
                  "live_pipelines"])
    assert len(names) == probe_channel_count(len(resource_names))
    return names


@dataclasses.dataclass(frozen=True)
class ProbeTimeline:
    """A probed run's named telemetry timelines.

    ``times [E]`` is the compile-time tick grid; ``values [E, K]`` the
    engine-sampled channels (NaN rows past the run's last wave — the grid
    covers the full horizon but a run that drains early stops probing);
    ``channels`` names the K columns."""

    times: np.ndarray               # [E] f64
    values: np.ndarray              # [E, K] f64
    channels: Tuple[str, ...]

    @staticmethod
    def from_trace(tr: M.SimTrace, platform: M.PlatformConfig
                   ) -> Optional["ProbeTimeline"]:
        """Wrap a probed :class:`~repro_torch.core.model.SimTrace`; None when the
        run carried no probe."""
        if getattr(tr, "probe_vals", None) is None:
            return None
        names = probe_channel_names([r.name for r in platform.resources])
        vals = np.asarray(tr.probe_vals, np.float64)
        if vals.shape[1] != len(names):
            raise ValueError(
                f"probe buffer has {vals.shape[1]} channels but the "
                f"platform's {len(platform.resources)} resources imply "
                f"{len(names)}")
        return ProbeTimeline(times=np.asarray(tr.probe_times, np.float64),
                             values=vals, channels=tuple(names))

    @property
    def sampled(self) -> np.ndarray:
        """[E] bool — ticks the run actually reached (channel 0, queue
        depth, is always finite when the probe fired)."""
        return ~np.isnan(self.values[:, 0])

    def channel(self, name: str) -> np.ndarray:
        """One named channel's ``[E]`` timeline."""
        try:
            k = self.channels.index(name)
        except ValueError:
            raise KeyError(f"unknown probe channel {name!r}; "
                           f"have {list(self.channels)}") from None
        return self.values[:, k]

    def as_dict(self) -> Dict[str, np.ndarray]:
        """``{"t": times, <channel>: timeline, ...}`` — the dataframe-ready
        dashboard view."""
        out: Dict[str, np.ndarray] = {"t": self.times}
        out.update({c: self.values[:, k]
                    for k, c in enumerate(self.channels)})
        return out
