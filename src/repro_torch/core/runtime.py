"""Run-time view, Fig 3/7: declarative fleet and trigger specs, the
retraining-pool workload, and the lifecycle result (mirrors
:mod:`repro.core.runtime`).

Deployed models drift; drift detectors observe noisy performance; trigger
rules fire retraining pipelines; the retraining pipelines flow through the
simulated platform and, on completion, redeploy the model with restored
performance. :class:`FleetSpec` (how many models, which drift processes) and
:class:`TriggerSpec` (threshold, cooldown, observation noise, retrain
pipeline template) are ``ExperimentSpec`` fields, compiled by
:func:`repro_torch.ops.scenario.compile_fleet` into flat tensors that the
engine's fleet stage (:mod:`repro_torch.core.vdes`) runs inside its wave
loop.

The reference's legacy entry point stays as a thin wrapper over the spec
API: :func:`run_feedback_simulation` (with the scalar :class:`TriggerRule`)
builds the equivalent ``ExperimentSpec`` and runs it on the port's
``"torch"`` engine, on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import des
from repro_torch.core import model as M
from repro_torch.core.gmm import categorical
from repro_torch.core.metrics import FLEET_FIELDS, DeployedModel, pack_fleet
from repro_torch.core.trace import TaskRecords


# ---------------------------------------------------------------------------
# Declarative specs (ExperimentSpec.fleet / ExperimentSpec.trigger)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A fleet of M deployed models under drift (the run-time view).

    Either give explicit per-model drift processes as a
    ``[M, FLEET_FIELDS]`` tensor (``params``; columns documented in
    :mod:`repro_torch.core.metrics`), or let the fleet be sampled by
    :func:`make_model_fleet`: ``drift_scale`` multiplies drift intensities
    (the accelerated-aging knob for short-horizon experiments) and ``seed``
    optionally pins the fleet draw independently of the experiment seed.
    """

    n_models: int = 20
    drift_scale: float = 1.0
    seed: Optional[int] = None
    params: Optional[np.ndarray] = None     # explicit [M, FLEET_FIELDS]

    @property
    def name(self) -> str:
        parts = [f"m={self.n_models}"]
        if self.drift_scale != 1.0:
            parts.append(f"ds={self.drift_scale:g}")
        return "fleet(" + ",".join(parts) + ")"


@dataclasses.dataclass(frozen=True)
class TriggerSpec:
    """Execution trigger e (§III-A) and the retraining pipeline template.

    Every ``interval_s`` the engine's fleet stage observes each model's
    performance with Gaussian noise ``obs_noise``; when observed drift
    (``perf0 - observed``) exceeds ``drift_threshold`` outside the
    per-model ``cooldown_s`` window, a latent retraining pipeline
    (train -> evaluate -> deploy) is activated, arriving
    ``arrival_delay_s`` later. On completion the model redeploys with a
    presampled performance gain ``~ N(perf_gain_mu, perf_gain_sigma)``.

    ``max_retrains`` bounds the preallocated retraining-pipeline pool; None
    derives it from the cooldown/tick grid. ``retrain_durations`` pins
    deterministic (train, evaluate, deploy) execution times; otherwise
    durations are drawn per task type from the fitted params.
    """

    drift_threshold: float = 0.08
    cooldown_s: float = 12 * 3600.0
    obs_noise: float = 0.01
    interval_s: float = 6 * 3600.0
    arrival_delay_s: float = 1.0
    perf_gain_mu: float = 0.005
    perf_gain_sigma: float = 0.01
    max_retrains: Optional[int] = None
    retrain_durations: Optional[Tuple[float, float, float]] = None

    @property
    def name(self) -> str:
        parts = [f"th={self.drift_threshold:g}", f"cd={self.cooldown_s:g}",
                 f"iv={self.interval_s:g}"]
        if self.obs_noise:
            parts.append(f"on={self.obs_noise:g}")
        return "trig(" + ",".join(parts) + ")"


@dataclasses.dataclass
class TriggerRule:
    """Legacy scalar trigger (pre-spec API). Kept for back-compat: the
    :func:`run_feedback_simulation` wrapper converts it to a
    :class:`TriggerSpec` (``to_spec``)."""

    drift_threshold: float = 0.08
    cooldown_s: float = 12 * 3600.0
    obs_noise: float = 0.01

    def fires(self, m: DeployedModel, t: float, rng: np.random.Generator,
              last_fire: float) -> bool:
        obs_perf = m.performance(t) + rng.normal(0.0, self.obs_noise)
        drift = m.perf0 - obs_perf
        return drift > self.drift_threshold and (t - last_fire) >= self.cooldown_s

    def to_spec(self, interval_s: float) -> TriggerSpec:
        return TriggerSpec(drift_threshold=self.drift_threshold,
                           cooldown_s=self.cooldown_s,
                           obs_noise=self.obs_noise,
                           interval_s=interval_s)


# ---------------------------------------------------------------------------
# Fleet sampling
# ---------------------------------------------------------------------------

def make_model_fleet(rng: np.random.Generator, n_models: int,
                     t0: float = 0.0,
                     drift_scale: float = 1.0) -> List[DeployedModel]:
    """``drift_scale`` multiplies drift intensities (accelerated-aging knob
    for short-horizon experiments)."""
    fleet = []
    for i in range(n_models):
        fleet.append(DeployedModel(
            model_id=i,
            perf0=float(np.clip(rng.beta(10, 3), 0.5, 0.995)),
            deployed_at=t0,
            gradual_rate=float(rng.lognormal(np.log(2e-8), 0.8)) * drift_scale,
            jump_rate=float(rng.lognormal(np.log(1 / (14 * 24 * 3600)), 0.5))
            * drift_scale,
            jump_scale=float(rng.uniform(0.03, 0.15)),
            seasonal_amp=float(rng.uniform(0.0, 0.02)),
        ))
    return fleet


def fleet_tensor(spec: FleetSpec, seed: int) -> np.ndarray:
    """The ``[M, FLEET_FIELDS]`` f32 drift-process tensor for a
    :class:`FleetSpec` (explicit ``params`` verbatim, else sampled via
    :func:`make_model_fleet` with ``spec.seed`` or the experiment seed)."""
    if spec.params is not None:
        fl = np.array(spec.params, np.float32)
        if fl.ndim != 2 or fl.shape[1] != FLEET_FIELDS:
            raise ValueError(f"FleetSpec.params must be [M, {FLEET_FIELDS}], "
                             f"got {fl.shape}")
        if spec.drift_scale != 1.0:     # scale explicit drift intensities too
            fl[:, 1:3] *= np.float32(spec.drift_scale)
        return fl
    rng = np.random.default_rng(seed if spec.seed is None else spec.seed)
    return pack_fleet(make_model_fleet(rng, spec.n_models,
                                       drift_scale=spec.drift_scale))


# ---------------------------------------------------------------------------
# Retraining pipeline synthesis (the pool template)
# ---------------------------------------------------------------------------

def retrain_draws(params, gen: torch.Generator, n: int) -> dict:
    """The random draws of :func:`synthesize_retrain_workload`, in the
    reference's order, as host arrays: frameworks ``fw``, per-pipeline
    log train seconds ``log_train``, logit performance ``logit_perf``, log
    evaluate seconds ``log_eval``, deploy seconds ``t_depl`` and the
    standard normals ``zsz`` (model size) and ``zclever``. Each framework's
    train and performance draws are made for its pipelines together, as the
    reference's are."""
    dev = gen.device
    mix = torch.as_tensor(np.asarray(params.framework_mix), dtype=torch.float32,
                          device=dev)
    fw = categorical(gen, torch.log(mix + 1e-12), n).cpu().numpy().astype(
        np.int32)
    log_train = np.zeros(n, np.float32)
    logit_perf = np.zeros(n, np.float32)
    for f in range(M.N_FRAMEWORKS):
        m = fw == f
        k = int(m.sum())
        if not k:
            continue
        log_train[m] = params.train_loggmm[f].sample(gen, k)[:, 0].cpu().numpy()
        logit_perf[m] = params.model_perf_loggmm[f].sample(
            gen, k)[:, 0].cpu().numpy()
    log_eval = params.eval_loggmm.sample(gen, n)[:, 0].cpu().numpy()
    t_depl = params.deploy.sample(gen, (n,)).cpu().numpy()
    zsz = torch.randn((n,), generator=gen, device=dev).cpu().numpy()
    zclever = torch.randn((n,), generator=gen, device=dev).cpu().numpy()
    return dict(fw=fw, log_train=log_train, logit_perf=logit_perf,
                log_eval=log_eval, t_depl=t_depl, zsz=zsz, zclever=zclever)


def retrain_workload_from_draws(params, draws: dict, platform: M.PlatformConfig,
                                max_tasks: int) -> M.Workload:
    """The deterministic transform of :func:`retrain_draws` into ``n``
    latent retraining pipelines: the reference's arithmetic, op for op."""
    fw = draws["fw"]
    n = fw.shape[0]
    t_train = np.zeros(n)
    perf = np.zeros(n, np.float32)
    for f in range(M.N_FRAMEWORKS):
        m = fw == f
        if m.any():
            t_train[m] = np.exp(draws["log_train"][m])
            perf[m] = 1.0 / (1.0 + np.exp(-draws["logit_perf"][m]))
    t_eval = np.exp(draws["log_eval"])
    t_depl = draws["t_depl"]
    msize = np.exp(params.model_size_logmu[fw]
                   + params.model_size_logsd[fw] * draws["zsz"])
    clever = np.exp(draws["zclever"] * 0.5 + np.log(0.3))
    exec3 = np.stack([np.maximum(t_train, 1e-2), np.maximum(t_eval, 1e-2),
                      np.maximum(t_depl, 1e-2)], 1)
    return _pool_workload(n, max_tasks, platform, exec3, fw, perf,
                          msize.astype(np.float32),
                          clever.astype(np.float32))


def synthesize_retrain_workload(params, gen: torch.Generator, n: int,
                                platform: M.PlatformConfig,
                                max_tasks: int) -> M.Workload:
    """``n`` retraining pipelines (train -> evaluate -> deploy) with
    per-task-type durations drawn from the fitted params distributions,
    each pipeline with its own draws from ``gen`` (where the reference
    draws with ``jax.random``). Arrivals are ``inf``: latent until a trigger
    activates them."""
    return retrain_workload_from_draws(params, retrain_draws(params, gen, n),
                                       platform, max_tasks)


def _pool_workload(n: int, max_tasks: int, platform: M.PlatformConfig,
                   exec3: np.ndarray, framework=None, model_perf=None,
                   model_size=None, model_clever=None) -> M.Workload:
    """Assemble ``n`` latent train->evaluate->deploy pipelines with the given
    ``[n, 3]`` exec times (IO-free so integer-time parity workloads stay
    integral)."""
    if max_tasks < 3:
        raise ValueError("retraining pipelines need max_tasks >= 3 "
                         "(train -> evaluate -> deploy); the workload's "
                         f"task tensors are only {max_tasks} wide")
    tt = np.full((n, max_tasks), -1, np.int32)
    if n:
        tt[:, 0], tt[:, 1], tt[:, 2] = M.TRAIN, M.EVALUATE, M.DEPLOY
    exec_time = np.zeros((n, max_tasks))
    exec_time[:, :3] = exec3
    return M.Workload(
        arrival=np.full(n, np.inf),
        n_tasks=np.full(n, 3, np.int32),
        task_type=tt,
        task_res=(platform.route(np.maximum(tt, 0)) * (tt >= 0)).astype(
            np.int32),
        exec_time=exec_time,
        read_bytes=np.zeros((n, max_tasks)),
        write_bytes=np.zeros((n, max_tasks)),
        framework=np.zeros(n, np.int32) if framework is None else framework,
        priority=np.ones(n, np.float32),
        model_perf=np.zeros(n, np.float32) if model_perf is None
        else model_perf,
        model_size=np.zeros(n, np.float32) if model_size is None
        else model_size,
        model_clever=np.zeros(n, np.float32) if model_clever is None
        else model_clever,
    )


def _concat_workloads(a: M.Workload, b: M.Workload) -> M.Workload:
    cat = lambda x, y: np.concatenate([x, y], 0)
    return M.Workload(
        arrival=cat(a.arrival, b.arrival),
        n_tasks=cat(a.n_tasks, b.n_tasks),
        task_type=cat(a.task_type, b.task_type),
        task_res=cat(a.task_res, b.task_res),
        exec_time=cat(a.exec_time, b.exec_time),
        read_bytes=cat(a.read_bytes, b.read_bytes),
        write_bytes=cat(a.write_bytes, b.write_bytes),
        framework=cat(a.framework, b.framework),
        priority=cat(a.priority, b.priority),
        model_perf=cat(a.model_perf, b.model_perf),
        model_size=cat(a.model_size, b.model_size),
        model_clever=cat(a.model_clever, b.model_clever),
    )


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LifecycleResult:
    """Model-lifecycle view of one run, decoded from the engine-recorded
    fleet tensors on the :class:`~repro_torch.core.model.SimTrace`."""

    tick_times: np.ndarray          # [E] drift-evaluation instants
    perf_timeline: np.ndarray       # [M, E] true performance at each tick
    staleness_timeline: np.ndarray  # [M, E]
    trigger_times: np.ndarray       # [n_triggered]
    trigger_models: np.ndarray
    redeploy_times: np.ndarray      # [n_retrained]
    redeploy_models: np.ndarray
    n_triggered: int
    n_retrained: int
    n_exogenous: int                # pipelines that were not retrains
    mean_staleness: float
    staleness_integral_s: float     # mean over models of ∫ staleness dt


def lifecycle_result(tr: M.SimTrace) -> Optional[LifecycleResult]:
    """Decode a trace's fleet columns (None when the run had no fleet)."""
    if tr.fleet_perf is None:
        return None
    kind = np.asarray(tr.fleet_kind, np.int64)
    trig = kind == des.FLEET_ACT_TRIGGER
    rede = kind == des.FLEET_ACT_REDEPLOY
    stale = np.asarray(tr.fleet_stale, np.float64)
    ticks = np.asarray(tr.fleet_ticks, np.float64)
    widths = np.diff(np.concatenate([[0.0], ticks]))
    integral = np.nansum(np.nan_to_num(stale, nan=0.0)
                         * widths[:, None], 0)
    return LifecycleResult(
        tick_times=ticks,
        perf_timeline=np.asarray(tr.fleet_perf, np.float64).T,
        staleness_timeline=stale.T,
        trigger_times=np.asarray(tr.fleet_times)[trig],
        trigger_models=np.asarray(tr.fleet_model)[trig],
        redeploy_times=np.asarray(tr.fleet_times)[rede],
        redeploy_models=np.asarray(tr.fleet_model)[rede],
        n_triggered=int(trig.sum()),
        n_retrained=int(rede.sum()),
        n_exogenous=int(tr.fleet_pool_base),
        mean_staleness=float(np.nanmean(stale)) if stale.size else 0.0,
        staleness_integral_s=float(np.mean(integral)) if integral.size
        else 0.0,
    )


@dataclasses.dataclass
class FeedbackResult:
    """Back-compat result shape of :func:`run_feedback_simulation`."""

    records: TaskRecords
    n_exogenous: int
    n_triggered: int
    perf_timeline: np.ndarray      # [n_models, n_ticks] true performance
    retrain_times: List[float]
    lifecycle: Optional[LifecycleResult] = None


# ---------------------------------------------------------------------------
# Thin wrapper (the reference's old windowed co-simulation entry point)
# ---------------------------------------------------------------------------

def run_feedback_simulation(
    params,
    seed: int,
    horizon_s: float,
    n_models: int = 20,
    window_s: float = 6 * 3600.0,
    trigger=None,
    platform: Optional[M.PlatformConfig] = None,
    policy: int = des.POLICY_FIFO,
    interarrival_factor: float = 1.0,
    drift_scale: float = 1.0,
    scenario=None,
    engine: str = "torch",
    fleet: Optional[FleetSpec] = None,
    workload: Optional[M.Workload] = None,
    device=None,
) -> FeedbackResult:
    """Fig 7 loop via the declarative spec API (thin wrapper).

    Builds the spec the reference's wrapper builds (``window_s`` becomes
    the drift-evaluation tick interval; ``trigger`` is a
    :class:`TriggerSpec`, a legacy :class:`TriggerRule` or None), runs it
    with :func:`repro_torch.core.experiment.run_experiment` on ``engine``
    on ``device`` (``None``: the card) and reshapes the result. ``params``
    are fitted :class:`~repro_torch.core.fitting.SimulationParams`.

    Two differences from the reference: the default engine is the port's
    ``"torch"`` (the reference's is its numpy engine), and ``workload``
    pins the spec's workload (``ExperimentSpec.workload``), so that two
    devices, whose generators draw different workloads, can run the same
    one.
    """
    from repro_torch.core.experiment import ExperimentSpec, run_experiment
    if trigger is None:
        tspec = TriggerSpec(interval_s=window_s)
    elif isinstance(trigger, TriggerSpec):
        tspec = trigger
    else:                               # legacy TriggerRule
        tspec = trigger.to_spec(interval_s=window_s)
    spec = ExperimentSpec(
        name="feedback",
        platform=platform or M.PlatformConfig(),
        horizon_s=horizon_s,
        interarrival_factor=interarrival_factor,
        policy=policy,
        seed=seed,
        engine=engine,
        scenario=scenario,
        workload=workload,
        fleet=fleet if fleet is not None
        else FleetSpec(n_models=n_models, drift_scale=drift_scale),
        trigger=tspec,
    )
    res = run_experiment(spec, params, device=device)
    lc = res.lifecycle
    if lc is None:
        raise RuntimeError("engine returned no lifecycle data")
    return FeedbackResult(
        records=res.records,
        n_exogenous=lc.n_exogenous,
        n_triggered=lc.n_triggered,
        perf_timeline=lc.perf_timeline,
        retrain_times=[float(t) for t in lc.redeploy_times],
        lifecycle=lc,
    )
