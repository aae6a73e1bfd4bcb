"""The port's model lifecycle (``core/metrics.py``'s fleet algebra,
``core/runtime.py``, ``ops/scenario.compile_fleet`` and the wave loop's
fleet stage) against the JAX package, on the CPU.

The JAX engine's fleet path fails on this tree (``repro.core.numerics``
cannot batch its barrier under this JAX), so the stage is held against the
numpy engine ``des.simulate`` only, fed the same compiled fleet, under the
reference's parity conditions: whole-second times, seasonal amplitude 0
and pinned retrain durations.

Tolerances: **bit for bit** for the engine, the numpy part of
``compile_fleet``, the retraining pool's transform on the reference's own
``jax.random`` draws, the summaries and the fleet algebra at seasonal
amplitude 0; 2 ulp where ``cos`` enters (seasonal amplitude > 0: libm
against torch). The pool's own torch draws are held in distribution (the
median of each retrain task's duration within 20 %, the framework mix
within 0.03, as the synthesizer's twin holds it).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_stage_cases as C
from repro.core import batching as ref_batching
from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.core import fitting as ref_fitting
from repro.core import metrics as ref_metrics
from repro.core import model as RM
from repro.core import runtime as ref_rt
from repro.ops import accounting as ref_acc
from repro.ops import capacity as ref_cap
from repro.ops import scenario as ref_scen
from repro_torch.core import batching, experiment, fitting, metrics
from repro_torch.core import model as M
from repro_torch.core import runtime, vdes
from repro_torch.core.workload import generate_empirical_workload, whole_seconds
from repro_torch.ops import accounting, capacity, scenario

# three redeploy gains whose f32 sum the order of the adds changes, by one
# ulp of the model's performance (chip_smoke.py's FSO_BURST_GAINS)
BURST_GAINS = np.array([0.008586719632148743, 0.018224574625492096,
                        0.004860853310674429], np.float32)
BURST_PERF0 = np.float32(0.88772327)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    from pathlib import Path
    path = str(Path(__file__).resolve().parents[1] / "artifacts" /
               "pipesim_params.npz")
    return (ref_fitting.SimulationParams.load(path),
            fitting.SimulationParams.load(path, device="cpu"))


@pytest.mark.parametrize("amp", [0.0, 0.02])
def test_fleet_algebra_matches_reference(amp):
    """``fleet_performance_acc`` and ``fleet_staleness`` in torch f32 over
    an ``[R, M]`` batch against the reference's numpy f32, row by row."""
    rng = np.random.default_rng(1)
    R, M_ = 3, 5
    fl = ref_runtime_fleet(rng, M_, amp)
    perf0 = rng.uniform(0.6, 0.99, (R, M_)).astype(np.float32)
    acc = rng.exponential(0.02, (R, M_)).astype(np.float32)
    dt = np.floor(rng.uniform(0, 86400, (R, M_))).astype(np.float32)
    got = metrics.fleet_performance_acc(
        torch.from_numpy(perf0), torch.from_numpy(acc), torch.from_numpy(dt),
        torch.from_numpy(np.broadcast_to(fl, (R,) + fl.shape).copy()),
        xp=torch)
    want = np.stack([ref_metrics.fleet_performance_acc(perf0[r], acc[r],
                                                       dt[r], fl, xp=np)
                     for r in range(R)]).astype(np.float32)
    if amp == 0.0:
        C.assert_same(got.numpy(), want, "perf")
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    C.assert_same(metrics.fleet_staleness(torch.from_numpy(perf0), got,
                                          xp=torch).numpy(),
                  ref_metrics.fleet_staleness(perf0, got.numpy(), xp=np),
                  "stale")
    m = metrics.DeployedModel(0, 0.9, 0.0, 1e-6, 1e-5, 0.1, seasonal_amp=amp)
    r = ref_metrics.DeployedModel(0, 0.9, 0.0, 1e-6, 1e-5, 0.1,
                                  seasonal_amp=amp)
    assert m.staleness(5000.0) == r.staleness(5000.0)
    assert m.potential_improvement(5000.0, 0.3) == \
        r.potential_improvement(5000.0, 0.3)


def ref_runtime_fleet(rng, M_, amp):
    fl = ref_metrics.pack_fleet(ref_rt.make_model_fleet(rng, M_,
                                                        drift_scale=50.0))
    fl[:, ref_metrics.FLEET_SEAS_AMP] = amp
    return fl


def test_fleet_specs_and_tensors_equal_reference():
    explicit = np.random.default_rng(2).uniform(0, 1, (3, 6))
    for spec, rspec in (
            (runtime.FleetSpec(n_models=7, drift_scale=30.0),
             ref_rt.FleetSpec(n_models=7, drift_scale=30.0)),
            (runtime.FleetSpec(seed=4), ref_rt.FleetSpec(seed=4)),
            (runtime.FleetSpec(params=explicit, drift_scale=2.0),
             ref_rt.FleetSpec(params=explicit, drift_scale=2.0))):
        C.assert_same(runtime.fleet_tensor(spec, 9),
                      ref_rt.fleet_tensor(rspec, 9), spec.name)
        assert spec.name == rspec.name
    t = dict(drift_threshold=0.05, cooldown_s=60.0, obs_noise=0.0)
    assert runtime.TriggerSpec(**t).name == ref_rt.TriggerSpec(**t).name


@pytest.mark.parametrize("trig", [
    dict(interval_s=900.0, obs_noise=0.005, retrain_durations=(300, 60, 30)),
    dict(interval_s=3600.0, cooldown_s=0.0, max_retrains=5,
         retrain_durations=(10.5, 2.0, 1.0)),
    dict(interval_s=1800.0)])
def test_compile_fleet_equals_reference(params, trig):
    """Every numpy tensor of the compiled fleet (drift processes, trigger
    header, observation noise, drift increments, gains, tick grid, pool
    base) equals the reference's; with pinned durations the extended
    workload does too, else the pool's structure does (its durations are
    the torch generator's)."""
    H = 0.25 * 86400.0
    wl = generate_empirical_workload(4, H)
    rp, pp = params
    want, wext = ref_scen.compile_fleet(
        ref_rt.FleetSpec(n_models=5, drift_scale=40.0),
        ref_rt.TriggerSpec(**trig), wl, RM.PlatformConfig(), H, seed=6,
        params=rp)
    got, gext = scenario.compile_fleet(
        runtime.FleetSpec(n_models=5, drift_scale=40.0),
        runtime.TriggerSpec(**trig), wl, M.PlatformConfig(), H, seed=6,
        params=pp)
    for f in dataclasses.fields(want):
        C.assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    pinned = "retrain_durations" in trig
    for f in dataclasses.fields(wext):
        if pinned or f.name in ("arrival", "n_tasks", "task_type",
                                "task_res", "priority", "read_bytes",
                                "write_bytes"):
            C.assert_same(getattr(gext, f.name), getattr(wext, f.name),
                          f.name)
    assert (got.n_models, got.n_pool, got.n_ticks) == \
        (want.n_models, want.n_pool, want.n_ticks)


def _reference_draws(rp, key, n):
    """The reference's ``synthesize_retrain_workload`` draws, in its order
    and key splits."""
    keys = jax.random.split(key, 8)
    fw = np.asarray(jax.random.categorical(
        keys[0], np.log(np.asarray(rp.framework_mix) + 1e-12),
        shape=(n,))).astype(np.int32)
    log_train = np.zeros(n, np.float32)
    logit_perf = np.zeros(n, np.float32)
    for f in range(RM.N_FRAMEWORKS):
        m = fw == f
        if m.any():
            log_train[m] = np.asarray(rp.train_loggmm[f].sample(
                jax.random.fold_in(keys[1], f), int(m.sum())))[:, 0]
            logit_perf[m] = np.asarray(rp.model_perf_loggmm[f].sample(
                jax.random.fold_in(keys[2], f), int(m.sum())))[:, 0]
    return dict(
        fw=fw, log_train=log_train, logit_perf=logit_perf,
        log_eval=np.asarray(rp.eval_loggmm.sample(keys[3], n))[:, 0],
        t_depl=np.asarray(rp.deploy.sample(keys[4], (n,))),
        zsz=np.asarray(jax.random.normal(keys[5], (n,))),
        zclever=np.asarray(jax.random.normal(keys[6], (n,))))


def test_retrain_transform_on_reference_draws(params):
    """Fed the reference's own ``jax.random`` draws, the port's transform
    gives the reference's retraining pool exactly."""
    rp, pp = params
    key = jax.random.PRNGKey(5)
    want = ref_rt.synthesize_retrain_workload(rp, key, 200,
                                              RM.PlatformConfig(), 6)
    got = runtime.retrain_workload_from_draws(
        pp, _reference_draws(rp, key, 200), M.PlatformConfig(), 6)
    for f in dataclasses.fields(want):
        C.assert_same(getattr(got, f.name), getattr(want, f.name), f.name)


def test_retrain_draws_match_reference_in_distribution(params):
    rp, pp = params
    n = 4000
    want = ref_rt.synthesize_retrain_workload(
        rp, jax.random.PRNGKey(0), n, RM.PlatformConfig(), 6)
    got = runtime.synthesize_retrain_workload(
        pp, torch.Generator().manual_seed(0), n, M.PlatformConfig(), 6)
    assert np.isinf(got.arrival).all() and (got.n_tasks == 3).all()
    C.assert_same(got.task_type, want.task_type, "task_type")
    for j in range(3):
        a, b = np.median(got.exec_time[:, j]), np.median(want.exec_time[:, j])
        assert abs(a / b - 1.0) < 0.2, (j, a, b)
    mix_a = np.bincount(got.framework, minlength=RM.N_FRAMEWORKS) / n
    mix_b = np.bincount(want.framework, minlength=RM.N_FRAMEWORKS) / n
    assert np.abs(mix_a - mix_b).max() < 0.03


def _fleet_case(mod_rt, mod_scen, wl, plat, i, H):
    """Replica ``i``'s compiled fleet: a 4-model fleet under fast drift
    (seasonal amplitude 0) with pinned whole-second retrain durations."""
    fl = mod_rt.fleet_tensor(mod_rt.FleetSpec(n_models=3 + i,
                                              drift_scale=3000.0), 40 + i)
    fl[:, 4] = 0.0
    trig = mod_rt.TriggerSpec(drift_threshold=0.02, cooldown_s=60.0 * i,
                              obs_noise=0.004, interval_s=50.0,
                              retrain_durations=(40.0, 10.0, 5.0))
    return mod_scen.compile_fleet(mod_rt.FleetSpec(params=fl), trig, wl,
                                  plat, H, seed=i)


@pytest.fixture(scope="module")
def case():
    """A lifecycle ensemble: replicas 0-2 with fleets (cooldowns 0, 60,
    120 s), replica 3 without (the disabled padding row)."""
    rp, pp = C.platforms()
    base = C.workloads(23, sizes=(C.N, C.N - 3, C.N - 8, C.N))
    rfl, wls, pfl, pwls = [], [], [], []
    for i, w in enumerate(base):
        if i == 3:
            rfl.append(None), pfl.append(None)
            wls.append(w), pwls.append(C.port_workload(w))
            continue
        a, wa = _fleet_case(ref_rt, ref_scen, w, rp, i, C.HORIZON)
        b, wb = _fleet_case(runtime, scenario, C.port_workload(w), pp, i,
                            C.HORIZON)
        rfl.append(a), wls.append(wa), pfl.append(b), pwls.append(wb)
    rc, pc = C.stacked(None, None, wls, pwls, (rp, pp))
    rc.update(ref_batching.stack_fleets(rfl, rc["n_max"]))
    pc.update(batching.stack_fleets(pfl, pc["n_max"]))
    caps = np.array([C.CAPS] * C.R, np.int32)
    return dict(wls=wls, pwls=pwls, rfl=rfl, pfl=pfl, rc=rc, pc=pc,
                plats=(rp, pp), port=C.run_port(pc, caps))


def test_fleet_ensemble_equals_numpy_engine(case):
    """Each replica's performance/staleness timelines, trigger/redeploy
    timeline, pool activations, task times, completion and (where no
    padding row runs) wave count equal ``des.simulate``'s, fed the same
    compiled fleet; the stacked columns equal the reference's."""
    C.assert_same_cols(case["rc"], case["pc"])
    rp = case["plats"][0]
    out = {k: torch.from_numpy(v) for k, v in case["port"].items()}
    for i, wl in enumerate(case["wls"]):
        tr = ref_des.simulate(wl, rp, 0, fleet=case["rfl"][i])
        got = batching.batch_trace(out, i, case["pwls"][i], rp.capacities,
                                   with_scenario=False, fleet=case["pfl"][i])
        for k in ("start", "finish", "ready", "arrival", "completed",
                  "fleet_perf", "fleet_stale", "fleet_ticks", "fleet_times",
                  "fleet_kind", "fleet_model", "fleet_pool_base"):
            a, b = getattr(got, k), getattr(tr, k)
            assert (a is None) == (b is None), (i, k)
            if b is not None:
                C.assert_same(a, b, f"{i} {k}")
        if i < 3:
            assert (tr.fleet_kind == 1).sum() > 0, i
        if wl.n == case["rc"]["n_max"]:
            assert got.waves == tr.waves, i
    assert int(case["port"]["fleet_n"][3]) == 0


def test_lifecycle_summary_and_result_equal_reference(case):
    rp, pp = case["plats"]
    for i in range(3):
        tr = ref_des.simulate(case["wls"][i], rp, 0, fleet=case["rfl"][i])
        assert C.same_tree(accounting.lifecycle_summary(tr),
                           ref_acc.lifecycle_summary(tr))
        a, b = runtime.lifecycle_result(tr), ref_rt.lifecycle_result(tr)
        for f in dataclasses.fields(b):
            C.assert_same(getattr(a, f.name), getattr(b, f.name), f.name)


def _burst_case():
    """One model that fires at three ticks while its evaluate/deploy pool is
    drained, so the three retrains redeploy in one wave: the reference's
    numpy trace and the port's inputs."""
    p0, g = BURST_PERF0, BURST_GAINS
    H = C.HORIZON
    plats = tuple(mod.PlatformConfig(resources=(
        mod.ResourceConfig("a", 50), mod.ResourceConfig("b", 3)))
        for mod in (RM, M))
    wl = C.workloads(29, sizes=(30,))[0]
    fl = np.array([[p0, 1e-5, 0.0, 0.05, 0.0, 86400.0]], np.float32)
    out = []
    for mod_rt, mod_scen, mod_cap, w, plat in (
            (ref_rt, ref_scen, ref_cap, wl, plats[0]),
            (runtime, scenario, capacity, C.port_workload(wl), plats[1])):
        cf, ext = mod_scen.compile_fleet(
            mod_rt.FleetSpec(params=fl),
            mod_rt.TriggerSpec(drift_threshold=0.0, cooldown_s=0.0,
                               obs_noise=0.0, interval_s=60.0,
                               max_retrains=3,
                               retrain_durations=(50.0, 10.0, 5.0)),
            w, plat, H, seed=0)
        cf = dataclasses.replace(cf, pool_gain=g)
        comp = mod_scen.Scenario(capacity=mod_cap.MaintenanceWindows(
            ((100.0, 300.0, 0, 0.0),))).compile(ext, plat, H)
        out.append((cf, ext, comp))
    (rcf, rext, rcomp), (pcf, pext, pcomp) = out
    tr = ref_des.simulate(rext, plats[0], 0, scenario=rcomp, fleet=rcf)
    return tr, pext, plats[1], pcomp, pcf


def test_three_same_model_redeploys_in_one_wave_add_in_slot_order():
    """The three redeploys of ``_burst_case`` in one wave: their gains (an
    order-sensitive triple: the other association moves the model's
    performance by an ulp) add in slot order, as the numpy mirror adds
    them: the performance timelines equal ``des.simulate``'s."""
    p0, g = BURST_PERF0, BURST_GAINS
    assert np.float32(p0 + np.float32(np.float32(g[0] + g[1]) + g[2])) != \
        np.float32(p0 + np.float32(g[0] + np.float32(g[1] + g[2])))
    tr, pext, plat, pcomp, pcf = _burst_case()
    got = vdes.simulate_to_trace(pext, plat, 0, scenario=pcomp,
                                 fleet=pcf, device="cpu")
    rede = tr.fleet_times[tr.fleet_kind == 1]
    assert rede.shape[0] == 3 and len(set(rede.tolist())) == 1
    for k in ("fleet_perf", "fleet_stale", "fleet_times", "fleet_kind",
              "fleet_model", "start", "finish", "arrival"):
        C.assert_same(getattr(got, k), getattr(tr, k), k)
    assert got.waves == tr.waves
    assert vdes.gain_order_bound(pcf.trig[None], 3) == 3


def test_short_gain_order_bound_raises(monkeypatch):
    """Were the bound on one model's redeploys in a wave short, the third
    gain of ``_burst_case`` would match no column of the ordered fold; the
    engine reports that instead of dropping the gain."""
    _, pext, plat, pcomp, pcf = _burst_case()
    monkeypatch.setattr(vdes, "gain_order_bound", lambda trig, n_pool: 2)
    with pytest.raises(RuntimeError, match="redeployed 3 retraining-pool"):
        vdes.simulate_to_trace(pext, plat, 0, scenario=pcomp, fleet=pcf,
                               device="cpu")


def test_empty_retraining_pool_equals_numpy_engine():
    """``max_retrains=0``: a fleet that drifts and records its timelines
    with no pool to trigger, as the numpy engine runs it."""
    rp, pp = C.platforms()
    wl = C.workloads(37, sizes=(C.N,))[0]
    (rcf, rext), (pcf, pext) = (
        mod_scen.compile_fleet(
            mod_rt.FleetSpec(n_models=2, drift_scale=3000.0),
            mod_rt.TriggerSpec(interval_s=60.0, max_retrains=0,
                               retrain_durations=(5.0, 5.0, 5.0)),
            w, plat, C.HORIZON, seed=1)
        for mod_rt, mod_scen, w, plat in (
            (ref_rt, ref_scen, wl, rp),
            (runtime, scenario, C.port_workload(wl), pp)))
    rcf = dataclasses.replace(rcf, fleet=rcf.fleet * np.array(
        [1, 1, 1, 1, 0, 1], np.float32))
    pcf = dataclasses.replace(pcf, fleet=rcf.fleet)
    tr = ref_des.simulate(rext, rp, 0, fleet=rcf)
    got = vdes.simulate_to_trace(pext, pp, 0, fleet=pcf, device="cpu")
    assert pcf.n_pool == 0
    for k in ("fleet_perf", "fleet_stale", "fleet_times", "start", "finish"):
        C.assert_same(getattr(got, k), getattr(tr, k), k)
    assert got.waves == tr.waves


def _sweep_base(mod_exp, mod_rt, wl, plat, H):
    fl = np.random.default_rng(3).uniform(0.0, 1.0, (4, 6)).astype(
        np.float32)
    fl[:, 0] = np.linspace(0.8, 0.95, 4)
    fl[:, 1] = 1e-5
    fl[:, 2] = 5e-4
    fl[:, 3] = 0.05
    fl[:, 4] = 0.0
    return mod_exp.ExperimentSpec(
        name="lc", platform=plat, horizon_s=H, seed=1, n_replicas=2,
        workload=wl, fleet=mod_rt.FleetSpec(params=fl),
        trigger=mod_rt.TriggerSpec(interval_s=600.0, obs_noise=0.005,
                                   cooldown_s=1200.0,
                                   retrain_durations=(600.0, 60.0, 30.0)))


def test_controller_by_trigger_sweep_is_one_call(monkeypatch):
    """A ``controller`` x ``trigger:drift_threshold`` Sweep (2 x 2 points,
    2 replicas each) runs as ONE ``simulate_ensemble`` call; each point
    equals its own run and the reference's numpy engine summary, the
    lifecycle and planned/realized blocks included."""
    H = 0.1 * 86400.0
    plat = M.PlatformConfig().with_capacity("learning_cluster", 8)
    rplat = RM.PlatformConfig().with_capacity("learning_cluster", 8)
    pwl = whole_seconds(generate_empirical_workload(31, H), plat.datastore)
    rwl = RM.Workload(**{f.name: getattr(pwl, f.name)
                         for f in dataclasses.fields(pwl)})
    ctrl = dict(high_watermark=0.3, step=0.5, max_scale=3.0, interval_s=900.0)
    axes = lambda cap: {"controller": [None, cap.ReactiveController(**ctrl)],
                        "trigger:drift_threshold": [0.01, 0.05]}
    calls = []
    real = vdes.simulate_ensemble
    monkeypatch.setattr(vdes, "simulate_ensemble",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = _sweep_base(experiment, runtime, pwl, plat, H)
    got = experiment.Sweep(base, axes(capacity)).run(device="cpu")
    assert len(calls) == 1
    want = ref_exp.Sweep(_sweep_base(ref_exp, ref_rt, rwl, rplat, H),
                         axes(ref_cap)).run()
    pts = experiment.Sweep(base, axes(capacity)).points()
    for p, g, w in zip(pts, got, want):
        one = experiment.run_experiment(p, device="cpu")
        assert g.experiment.name == w.experiment.name == p.name
        for a, b, d in zip(g.replica_summaries, w.replica_summaries,
                           one.replica_summaries):
            a, b, d = (C.without_wall(x) for x in (a, b, d))
            assert C.same_tree(a, b) and C.same_tree(a, d), p.name
            assert a["n_triggered"] > 0
    assert len(calls) == 1 + len(pts)


def test_single_replica_result_carries_lifecycle_and_timeline():
    """A one-replica full-stack spec through ``run_experiment`` gives the
    reference's ``lifecycle`` and ``timeline`` views, equal to the numpy
    engine's."""
    from repro.obs.probes import ProbeSpec as RefProbe
    from repro_torch.obs.probes import ProbeSpec
    H = 0.1 * 86400.0
    plat = M.PlatformConfig().with_capacity("learning_cluster", 8)
    rplat = RM.PlatformConfig().with_capacity("learning_cluster", 8)
    pwl = whole_seconds(generate_empirical_workload(33, H), plat.datastore)
    rwl = RM.Workload(**{f.name: getattr(pwl, f.name)
                         for f in dataclasses.fields(pwl)})
    got = experiment.run_experiment(dataclasses.replace(
        _sweep_base(experiment, runtime, pwl, plat, H), n_replicas=1,
        probe=ProbeSpec(interval_s=900.0)), device="cpu")
    want = ref_exp.run_experiment(dataclasses.replace(
        _sweep_base(ref_exp, ref_rt, rwl, rplat, H), n_replicas=1,
        engine="numpy", probe=RefProbe(interval_s=900.0)))
    for f in dataclasses.fields(want.lifecycle):
        C.assert_same(getattr(got.lifecycle, f.name),
                      getattr(want.lifecycle, f.name), f.name)
    C.assert_same(got.timeline.values, want.timeline.values, "timeline")
    assert got.timeline.channels == want.timeline.channels
    assert C.same_tree(C.without_wall(got.summary),
                       C.without_wall(want.summary))
