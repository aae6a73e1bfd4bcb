"""Operational scenario: capacity policy + failure/retry + outages + SLOs.

Numpy copy of the scenario half of :mod:`repro.ops.scenario` for the
PyTorch port. ``Scenario.compile`` materializes a declarative scenario
against a concrete workload/platform/horizon into a :class:`CompiledScenario`
— plain numpy tensors (capacity schedule, pre-sampled attempt counts,
backoff constants) that :func:`repro_torch.core.batching.stack_scenarios`
and :func:`repro_torch.core.batching.to_tensors` carry onto the device. The
same seed draws the same tensors as the reference. The closed-loop
controller and the model-lifecycle compiler arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import model as M
from repro_torch.ops.accounting import SLOConfig
from repro_torch.ops.capacity import (CapacitySchedule, StaticCapacity,
                                      apply_capacity_deltas, static_schedule)
from repro_torch.ops.failures import FailureModel, OutageModel, RetryPolicy


@dataclasses.dataclass(frozen=True)
class CompiledScenario:
    """Scenario materialized for one workload: what the engine executes."""

    schedule: CapacitySchedule
    attempts: np.ndarray                      # [N, T] i64 attempts per task
    backoff: Tuple[float, float, float] = (30.0, 2.0, 1800.0)
    # [N, T, A] per-attempt service times (retry resampling); None = every
    # attempt re-runs with the task's base service time (seed behavior)
    attempt_service: Optional[np.ndarray] = None
    # slot-holding fraction of a *failing* attempt (partial-progress
    # failures); 1.0 = hold for the full service time (historical semantics)
    fail_holds_frac: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.fail_holds_frac <= 1.0:
            raise ValueError(f"fail_holds_frac must be in (0, 1], got "
                             f"{self.fail_holds_frac}")

    @property
    def cap_times(self) -> np.ndarray:
        return self.schedule.times

    @property
    def cap_vals(self) -> np.ndarray:
        return self.schedule.caps


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative operational scenario. All parts optional — an empty
    Scenario compiles to the static platform (engine-identical to no
    scenario at all). ``controller`` is rejected: the closed-loop control
    stage is not ported yet."""

    name: str = "static"
    capacity: Optional[object] = None         # a capacity policy (.build(...))
    failures: Optional[FailureModel] = None
    outages: Optional[OutageModel] = None
    slo: Optional[SLOConfig] = None
    controller: Optional[object] = None

    def __post_init__(self):
        if self.controller is not None:
            raise NotImplementedError(
                "Scenario.controller: the closed-loop controller is not "
                "ported to repro_torch yet; run it on the reference engines")

    def compile_schedule(self, platform: M.PlatformConfig, horizon_s: float,
                         seed: int = 0, workload: Optional[M.Workload] = None,
                         policy: int = 0) -> CapacitySchedule:
        """Capacity schedule only (stable across co-simulation windows)."""
        base = platform.capacities
        pol = self.capacity or StaticCapacity()
        sched = pol.build(base, horizon_s, workload=workload,
                          platform=platform, policy=policy)
        if self.outages is not None:
            rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD0]))
            sched = apply_capacity_deltas(
                sched, self.outages.sample_outages(rng, horizon_s, base))
        return sched

    def compile(self, workload: M.Workload, platform: M.PlatformConfig,
                horizon_s: float, seed: int = 0, policy: int = 0,
                schedule: Optional[CapacitySchedule] = None
                ) -> CompiledScenario:
        """Materialize against ``workload``. Pass a pre-built ``schedule`` to
        reuse one across windows while re-sampling failures per window."""
        if schedule is None:
            schedule = self.compile_schedule(platform, horizon_s, seed=seed,
                                             workload=workload, policy=policy)
        attempt_service = None
        fail_holds_frac = 1.0
        if self.failures is not None:
            rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF0]))
            attempts = self.failures.sample_attempts(rng, workload)
            backoff = self.failures.retry.backoff
            fail_holds_frac = float(self.failures.fail_holds_frac)
            if self.failures.resample_service:
                rng_svc = np.random.default_rng(
                    np.random.SeedSequence([seed, 0xA5]))
                attempt_service = self.failures.sample_attempt_services(
                    rng_svc, workload.service_time(platform.datastore))
        else:
            attempts = np.ones(workload.task_type.shape, np.int64)
            backoff = RetryPolicy().backoff
        return CompiledScenario(schedule=schedule, attempts=attempts,
                                backoff=backoff,
                                attempt_service=attempt_service,
                                fail_holds_frac=fail_holds_frac)


def compile_static(workload: M.Workload,
                   platform: M.PlatformConfig) -> CompiledScenario:
    """The no-op scenario (useful as an explicit baseline)."""
    return CompiledScenario(schedule=static_schedule(platform.capacities),
                            attempts=np.ones(workload.task_type.shape,
                                             np.int64))


def stack_compiled_scenarios(compiled, n_max: int, horizon_s: float,
                             services=None) -> dict:
    """Pad/stack per-replica CompiledScenarios into the ``[R, ...]`` scenario
    kwargs of ``vdes.simulate_ensemble``, with per-attempt recording off (see
    :func:`repro_torch.core.batching.stack_scenarios`)."""
    from repro_torch.core.batching import stack_scenarios
    return stack_scenarios(compiled, n_max, horizon_s, services=services,
                           record_attempts=False)
