"""Operational scenario: capacity policy + failure/retry + outages + SLOs.

Numpy copy of :mod:`repro.ops.scenario` for the PyTorch port.
``Scenario.compile`` materializes a declarative scenario against a concrete
workload/platform/horizon into a :class:`CompiledScenario` — plain numpy
tensors (capacity schedule, pre-sampled attempt counts, backoff constants,
the flat ControllerParams vector) that
:func:`repro_torch.core.batching.stack_scenarios` and
:func:`repro_torch.core.batching.to_tensors` carry onto the device.
:func:`compile_fleet` does the same for the model lifecycle (a
:class:`~repro_torch.core.runtime.FleetSpec` and its
:class:`~repro_torch.core.runtime.TriggerSpec`). The same seed draws the
same numpy tensors as the reference; the retraining pool's durations, which
the reference draws with ``jax.random``, come from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import metrics as MET
from repro_torch.core import model as M
from repro_torch.ops.accounting import SLOConfig
from repro_torch.ops.capacity import (CapacitySchedule, StaticCapacity,
                                      apply_capacity_deltas, static_schedule)
from repro_torch.ops.failures import FailureModel, OutageModel, RetryPolicy


@dataclasses.dataclass(frozen=True)
class CompiledScenario:
    """Scenario materialized for one workload: what the engine executes.

    ``schedule`` is the *planned* capacity timeline; under a closed-loop
    ``controller`` the engine additionally records the realized action
    timeline (``SimTrace.ctrl_times``/``ctrl_caps``), which
    :func:`repro_torch.ops.accounting.realized_schedule` splices back onto
    this schedule for exact provisioned cost/utilization accounting."""

    schedule: CapacitySchedule
    attempts: np.ndarray                      # [N, T] i64 attempts per task
    backoff: Tuple[float, float, float] = (30.0, 2.0, 1800.0)
    # [N, T, A] per-attempt service times (retry resampling); None = every
    # attempt re-runs with the task's base service time (seed behavior)
    attempt_service: Optional[np.ndarray] = None
    # flat [C] ControllerParams tensor (closed-loop in-engine control; see
    # repro_torch.ops.capacity.ReactiveController.compile); None = none
    controller: Optional[np.ndarray] = None
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
    scenario at all)."""

    name: str = "static"
    capacity: Optional[object] = None         # a capacity policy (.build(...))
    failures: Optional[FailureModel] = None
    outages: Optional[OutageModel] = None
    slo: Optional[SLOConfig] = None
    # closed-loop in-engine controller (ops.capacity.ReactiveController):
    # composes with `capacity` as a delta on top of the planned schedule
    controller: Optional[object] = None

    def compile_schedule(self, platform: M.PlatformConfig, horizon_s: float,
                         seed: int = 0, workload: Optional[M.Workload] = None,
                         policy: int = 0, device=None) -> CapacitySchedule:
        """Capacity schedule only (stable across co-simulation windows).
        ``device`` is where a planning policy (``ReactiveAutoscaler``) runs
        its baseline simulations."""
        base = platform.capacities
        pol = self.capacity or StaticCapacity()
        sched = pol.build(base, horizon_s, workload=workload,
                          platform=platform, policy=policy, device=device)
        if self.outages is not None:
            rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD0]))
            sched = apply_capacity_deltas(
                sched, self.outages.sample_outages(rng, horizon_s, base))
        return sched

    def compile(self, workload: M.Workload, platform: M.PlatformConfig,
                horizon_s: float, seed: int = 0, policy: int = 0,
                schedule: Optional[CapacitySchedule] = None, device=None
                ) -> CompiledScenario:
        """Materialize against ``workload``. Pass a pre-built ``schedule`` to
        reuse one across windows while re-sampling failures per window."""
        if schedule is None:
            schedule = self.compile_schedule(platform, horizon_s, seed=seed,
                                             workload=workload, policy=policy,
                                             device=device)
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
        controller = None
        if self.controller is not None:
            controller = self.controller.compile(platform.capacities,
                                                 horizon_s)
        return CompiledScenario(schedule=schedule, attempts=attempts,
                                backoff=backoff,
                                attempt_service=attempt_service,
                                controller=controller,
                                fail_holds_frac=fail_holds_frac)


def compile_static(workload: M.Workload,
                   platform: M.PlatformConfig) -> CompiledScenario:
    """The no-op scenario (useful as an explicit baseline)."""
    return CompiledScenario(schedule=static_schedule(platform.capacities),
                            attempts=np.ones(workload.task_type.shape,
                                             np.int64))


# ---------------------------------------------------------------------------
# Model lifecycle (run-time view): FleetSpec/TriggerSpec -> flat tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompiledFleet:
    """Fleet + trigger materialized for one workload: what the engine's
    fleet stage executes. All randomness is presampled here, so the wave
    loop draws nothing:

    - ``fleet [M, FLEET_FIELDS]``: per-model drift-process parameters;
    - ``trig [TRIG_FIELDS]``: the trigger header (interval, cooldown,
      t_first, t_end, drift threshold, arrival delay);
    - ``obs_noise [E, M]``: per-tick observation noise;
    - ``drift_inc [E, M]``: presampled per-tick drift-loss increments
      (gradual ``rate * dt`` plus the sudden-drift compound-Poisson draws),
      accumulated by the engine with plain f32 adds;
    - ``pool_gain [P]``: per-pool-slot redeploy performance gains;
    - ``pool_base``: the extended workload's first latent retraining-pool
      row (``compile_fleet`` appends P train->evaluate->deploy pipelines
      with ``inf`` arrivals, the injection budget).
    """

    fleet: np.ndarray
    trig: np.ndarray
    obs_noise: np.ndarray
    drift_inc: np.ndarray
    pool_gain: np.ndarray
    pool_base: int
    tick_times: np.ndarray     # [E] f64 (values of the f32 tick grid)

    @property
    def n_models(self) -> int:
        return int(self.fleet.shape[0])

    @property
    def n_pool(self) -> int:
        return int(self.pool_gain.shape[0])

    @property
    def n_ticks(self) -> int:
        return int(self.tick_times.shape[0])


def compile_fleet(fleet_spec, trigger, workload: M.Workload,
                  platform: M.PlatformConfig, horizon_s: float,
                  seed: int = 0, params=None):
    """Materialize a :class:`~repro_torch.core.runtime.FleetSpec` +
    :class:`~repro_torch.core.runtime.TriggerSpec` against ``workload``:
    returns ``(CompiledFleet, extended_workload)`` where the extended
    workload is the exogenous pipelines followed by the latent retraining
    pool.

    Retrain durations come from ``trigger.retrain_durations`` when pinned
    (deterministic template, what integer-time parity tests use), else they
    are drawn per task type from the fitted ``params`` with a
    ``torch.Generator`` on the params' device, seeded as the reference seeds
    its ``jax.random`` key. Every other tensor is numpy's draw, equal to
    the reference's bit for bit.
    """
    from repro_torch.core import runtime as RT
    from repro_torch.core.des import TRIG_FIELDS, fleet_tick_grid

    if trigger.interval_s <= 0:
        raise ValueError("TriggerSpec.interval_s must be > 0")
    fleet = RT.fleet_tensor(fleet_spec, seed)
    M_ = fleet.shape[0]
    t_first = float(np.float32(trigger.interval_s))
    ticks = fleet_tick_grid(trigger.interval_s, t_first, horizon_s)
    E = ticks.shape[0]
    if E == 0:
        raise ValueError(
            f"TriggerSpec.interval_s={trigger.interval_s} exceeds the "
            f"horizon {horizon_s}; no drift-evaluation tick would ever fire")
    trig = np.zeros(TRIG_FIELDS, np.float32)
    trig[:] = (trigger.interval_s, trigger.cooldown_s, t_first, horizon_s,
               trigger.drift_threshold, trigger.arrival_delay_s)

    rng = np.random.default_rng(np.random.SeedSequence([max(seed, 0), 0xF1]))
    obs = (rng.normal(0.0, trigger.obs_noise, (E, M_))
           if trigger.obs_noise > 0 else np.zeros((E, M_)))
    # drift-loss increment per tick: gradual rate * dt plus the sudden-drift
    # compound Poisson (N ~ Poisson(rate * dt) jumps, each Exp(scale), so
    # the per-tick jump sum is Gamma(N, scale))
    widths = np.diff(np.concatenate([[0.0], ticks]))
    lam = (fleet[None, :, MET.FLEET_JUMP_RATE].astype(np.float64)
           * widths[:, None])
    n_jumps = rng.poisson(lam)
    drift_inc = (fleet[None, :, MET.FLEET_GRAD_RATE].astype(np.float64)
                 * widths[:, None]
                 + rng.gamma(n_jumps,
                             fleet[None, :, MET.FLEET_JUMP_SCALE]
                             .astype(np.float64)))

    # injection budget: at most one fire per model per cooldown window (and
    # never more than one per tick)
    if trigger.max_retrains is not None:
        P = int(trigger.max_retrains)
    else:
        eff_cd = max(trigger.cooldown_s, trigger.interval_s)
        per_model = int(np.floor(max(horizon_s - t_first, 0.0) / eff_cd)) + 1
        P = M_ * min(per_model, E)
    gains = rng.normal(trigger.perf_gain_mu, trigger.perf_gain_sigma, P)

    if trigger.retrain_durations is not None:
        exec3 = np.tile(np.asarray(trigger.retrain_durations,
                                   np.float64)[None, :], (P, 1))
        pool = RT._pool_workload(P, workload.max_tasks, platform, exec3)
    elif params is not None:
        import torch
        dev = params.eval_loggmm.means.device
        gen = torch.Generator(dev).manual_seed(
            (seed * 2654435761 + 0x5EED) % (1 << 31))
        pool = RT.synthesize_retrain_workload(params, gen, P, platform,
                                              workload.max_tasks)
    else:
        raise ValueError(
            "compile_fleet needs fitted params to draw retrain durations "
            "(or pin TriggerSpec.retrain_durations)")
    ext = RT._concat_workloads(workload, pool)
    compiled = CompiledFleet(
        fleet=fleet, trig=trig,
        obs_noise=obs.astype(np.float32),
        drift_inc=drift_inc.astype(np.float32),
        pool_gain=gains.astype(np.float32),
        pool_base=int(workload.n),
        tick_times=ticks)
    return compiled, ext


def stack_compiled_scenarios(compiled, n_max: int, horizon_s: float,
                             services=None) -> dict:
    """Pad/stack per-replica CompiledScenarios into the ``[R, ...]`` scenario
    kwargs of ``vdes.simulate_ensemble``, with per-attempt and realized
    controller-timeline recording off (see
    :func:`repro_torch.core.batching.stack_scenarios`)."""
    from repro_torch.core.batching import stack_scenarios
    return stack_scenarios(compiled, n_max, horizon_s, services=services,
                           record_attempts=False, record_ctrl=False)
