"""Declarative reliability layer: correlated failure domains, repair queues,
spot eviction, and checkpointed retrains (a copy of
:mod:`repro.reliability.specs`).

PipeSim's base failure channels (:mod:`repro_torch.ops.failures`) are i.i.d.
per-attempt coin flips plus independent Poisson node outages. What actually
takes down large AI fleets is *correlated*: a rack loses power, a zone
drains, repair crews saturate, spot pools get mass-evicted. This module is
the declarative half of that model — five small frozen specs composed into a
:class:`ReliabilitySpec` that :func:`repro_torch.reliability.compile.
compile_reliability` lowers into flat capacity-delta tensors both engines
consume through the control stage (the same machinery as capacity schedules
and closed-loop controllers, so the realized timeline and probe plane cover
reliability events for free).

Composition semantics with the existing failure channels:

  - Domain outages / spot evictions act on *capacity* (whole subtrees of the
    node->rack->zone tree go down and come back); they compose with
    ``CapacitySchedule``/``MaintenanceWindows`` deltas and controller moves
    additively, exactly like ``OutageModel``.
  - Spot eviction also acts on *tasks*: preemptible tasks draw extra service
    attempts (pre-sampled, the ``FailureModel.sample_attempts`` design) that
    ADD to the scenario's failure-retry attempts.
  - ``CheckpointSpec`` acts on *retry length*: a retry keeps ``ckpt_frac``
    progress, so retry attempts run ``(1 - ckpt_frac)`` of the base service
    time. This generalizes ``FailureModel.fail_holds_frac`` (which shortens
    the *failing* attempt's hold); configuring both on one experiment raises
    — the two would double-shrink a single failure+retry cycle.

Every spec has a ``.name`` so sweep axes (``"reliability:*"``) label their
grid points, mirroring :class:`repro_torch.core.runtime.TriggerSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Node -> rack -> zone failure-domain tree over every resource pool.

    Each pool's on-demand nodes are partitioned evenly across ``zones``
    zones and ``racks_per_zone`` racks per zone (remainders spread one node
    at a time, so counts are exact). A domain outage takes down the whole
    subtree — every pool loses its share of that domain *simultaneously*,
    which is what makes the outage correlated across resources.
    """

    zones: int = 2
    racks_per_zone: int = 4

    def __post_init__(self):
        if self.zones < 1 or self.racks_per_zone < 1:
            raise ValueError("topology needs >= 1 zone and >= 1 rack/zone")

    @property
    def name(self) -> str:
        return f"topo{self.zones}z{self.racks_per_zone}r"


@dataclasses.dataclass(frozen=True)
class DomainOutageModel:
    """Correlated outage processes per failure domain.

    Each zone (rack) independently fails as a Poisson process with mean time
    between failures ``zone_mtbf_s`` (``rack_mtbf_s``); an outage takes the
    domain's *entire* subtree down across all pools at once. Repair durations
    are Exp(``mttr_s``) draws — served instantly when no :class:`RepairSpec`
    is configured, or queued through the finite repair-crew FIFO when one is.
    ``resources`` restricts the affected pools (None = every pool).
    """

    zone_mtbf_s: float = 30 * 86400.0
    rack_mtbf_s: float = 10 * 86400.0
    mttr_s: float = 4 * 3600.0
    resources: Optional[Tuple[int, ...]] = None

    @property
    def name(self) -> str:
        return (f"out-z{self.zone_mtbf_s / 86400.0:g}d"
                f"-r{self.rack_mtbf_s / 86400.0:g}d")


@dataclasses.dataclass(frozen=True)
class RepairSpec:
    """Finite repair-crew service queue: failed capacity returns when a crew
    *finishes* the repair, not when the outage ends on its own. ``crews``
    concurrent repairs are served FIFO (``repro_torch.core.des.
    single_station_fifo`` — the exact c-server queue the engines use), so
    under saturation capacity return is queue-delayed, not instantaneous.
    ``repair_time_s`` is the mean Exp repair service time; None falls back
    to the outage model's ``mttr_s``."""

    crews: int = 2
    repair_time_s: Optional[float] = None

    def __post_init__(self):
        if self.crews < 1:
            raise ValueError("repair queue needs >= 1 crew")

    @property
    def name(self) -> str:
        return f"repair{self.crews}c"


@dataclasses.dataclass(frozen=True)
class SpotPoolSpec:
    """Preemptible (spot) slice of every pool: ``frac`` of each pool's nodes
    are spot, bought at ``discount`` x the on-demand rate. Mass evictions
    arrive as a Poisson process with mean time between evictions
    ``evict_mtbe_s``; an eviction takes the whole spot slice down for
    ``reclaim_s`` (market reclaim, no repair crew involved). Tasks running
    on evicted capacity draw extra retry attempts, pre-sampled per task
    with probability  frac * (1 - exp(-service / evict_mtbe_s))  — the
    chance a spot-placed task overlaps an eviction."""

    frac: float = 0.25
    evict_mtbe_s: float = 2 * 86400.0
    reclaim_s: float = 1800.0
    discount: float = 0.35

    def __post_init__(self):
        if not 0.0 <= self.frac < 1.0:
            raise ValueError(f"spot frac must be in [0, 1), got {self.frac}")
        if not 0.0 < self.discount <= 1.0:
            raise ValueError("spot discount is a price multiplier in (0, 1]")

    @property
    def name(self) -> str:
        return f"spot{int(round(self.frac * 100))}"


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Checkpointed retrains: a failed long task keeps ``ckpt_frac`` of its
    progress, so every *retry* attempt runs ``(1 - ckpt_frac)`` of the base
    service time. Generalizes ``FailureModel.fail_holds_frac`` (which only
    shortens the failing attempt's resource hold) to the recovery side; the
    two must not both be configured — see
    :func:`repro_torch.reliability.compile.check_no_double_apply`.

    ``fault_step_stride`` is the seconds of simulated time per training
    step of :meth:`injector`, the bridge to the training launcher."""

    ckpt_frac: float = 0.5
    fault_step_stride: float = 60.0   # seconds of sim time per training step

    def __post_init__(self):
        if not 0.0 <= self.ckpt_frac < 1.0:
            raise ValueError(
                f"ckpt_frac must be in [0, 1), got {self.ckpt_frac} "
                "(a full-progress checkpoint would make retries free)")
        if self.fault_step_stride <= 0:
            raise ValueError("fault_step_stride must be positive")

    @property
    def name(self) -> str:
        return f"ckpt{int(round(self.ckpt_frac * 100))}"

    def injector(self, compiled) -> "object":
        """A :class:`repro_torch.checkpoint.manager.FaultInjector` whose
        failure steps are the compiled reliability scenario's down-event
        times quantized to training steps (``t // fault_step_stride``): the
        simulator-to-launcher bridge for crash-restart runs
        (:func:`repro_torch.launch.train.run_training`)."""
        from repro_torch.checkpoint.manager import FaultInjector
        steps = sorted({int(ev.t_down // self.fault_step_stride)
                        for ev in compiled.events})
        return FaultInjector(steps)


@dataclasses.dataclass(frozen=True)
class ReliabilitySpec:
    """The umbrella spec :func:`repro_torch.reliability.compile.compile_reliability`
    lowers. Any component may be None (disabled); an all-None spec compiles
    to an empty event tensor (the engines' disabled path, bit-identical to
    not passing a reliability spec at all).

    ``time_quantum_s > 0`` snaps every compiled event time up to a multiple
    of the quantum (ceil). On an integer grid (quantum 1.0) event times stay
    exact in f32 *and* in every f32 sum the engines form with integer
    service times — the bit-parity configuration the twin tests and
    ``BENCH_reliability.json`` run; 0.0 (default) keeps the raw exponential
    arrival times."""

    topology: TopologySpec = TopologySpec()
    outages: Optional[DomainOutageModel] = DomainOutageModel()
    repair: Optional[RepairSpec] = RepairSpec()
    spot: Optional[SpotPoolSpec] = None
    checkpoint: Optional[CheckpointSpec] = None
    time_quantum_s: float = 0.0

    def __post_init__(self):
        if self.time_quantum_s < 0:
            raise ValueError("time_quantum_s must be >= 0")

    @property
    def name(self) -> str:
        parts = [self.topology.name]
        parts += [s.name for s in (self.outages, self.repair, self.spot,
                                   self.checkpoint) if s is not None]
        return "+".join(parts)
