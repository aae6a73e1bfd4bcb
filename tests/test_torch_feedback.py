"""The simulator's last host-side pieces in the port, against the JAX
package on the CPU: the legacy ``TriggerRule`` and
``run_feedback_simulation`` (``core/runtime.py``), the Table I compression
metrics (``core/metrics.py``) and the traffic panels
(``core/trace.arrivals_per_hour`` / ``network_traffic``).

All exact. The numpy helpers are copies, so their results are equal bit
for bit. ``run_feedback_simulation`` builds the reference's spec field for
field (its engine aside: the port's default is ``"torch"``) and returns
the port's own ``run_experiment`` of that spec; under the reference's
parity conditions (a whole-second pinned workload, seasonal amplitude 0,
pinned retrain durations) its result equals the reference's numpy engine
``des.simulate`` run on the same spec bit for bit, as
``tests/test_torch_lifecycle.py`` holds the fleet stage. (The reference's
JAX fleet path fails on this tree, so it is not the yardstick.)
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import experiment as ref_exp
from repro.core import metrics as ref_metrics
from repro.core import model as RM
from repro.core import runtime as ref_rt
from repro.core import trace as ref_trace
from repro_torch.core import experiment, fitting, metrics, runtime, trace
from repro_torch.core import model as M
from repro_torch.core.workload import generate_empirical_workload, whole_seconds

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "pipesim_params.npz"
H = 0.1 * 86400.0
TRIGGER = dict(drift_threshold=0.02, cooldown_s=1800.0, obs_noise=0.005,
               interval_s=900.0, retrain_durations=(600.0, 120.0, 60.0))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ TriggerRule

def test_trigger_rule_fires_and_to_spec_equal_reference():
    rule, rrule = (mod.TriggerRule(drift_threshold=0.03, cooldown_s=600.0,
                                   obs_noise=0.02)
                   for mod in (runtime, ref_rt))
    model = metrics.DeployedModel(0, 0.9, 0.0, 2e-6, 1e-5, 0.1)
    rmodel = ref_metrics.DeployedModel(0, 0.9, 0.0, 2e-6, 1e-5, 0.1)
    rng, rrng = np.random.default_rng(5), np.random.default_rng(5)
    got = [rule.fires(model, t, rng, last)
           for t in np.arange(0.0, 40000.0, 500.0) for last in (0.0, t)]
    want = [rrule.fires(rmodel, t, rrng, last)
            for t in np.arange(0.0, 40000.0, 500.0) for last in (0.0, t)]
    assert got == want and any(got) and not all(got)
    assert dataclasses.asdict(rule.to_spec(900.0)) == \
        dataclasses.asdict(rrule.to_spec(900.0))


# ------------------------------------------------------ compression metrics

@pytest.mark.parametrize("mode", ["interp", "poly"])
@pytest.mark.parametrize("arch", ["googlenet", "resnet50"])
@pytest.mark.parametrize("metric", ["accuracy", "size_mb", "inference_ms"])
def test_compression_effect_equals_reference(mode, arch, metric):
    prune = np.concatenate([metrics.PRUNE_LEVELS, np.linspace(-0.1, 1.1, 37)])
    np.testing.assert_array_equal(
        metrics.compression_effect(prune, arch, metric, mode),
        ref_metrics.compression_effect(prune, arch, metric, mode))


def test_apply_compression_equals_reference():
    rng = np.random.default_rng(2)
    perf, size = rng.uniform(0.5, 1, 50), rng.uniform(1, 100, 50)
    prune = rng.uniform(0, 0.8, 50)
    for arch in ("googlenet", "resnet50"):
        for kw in ({}, {"rng": "seeded"}):
            gen = lambda: (np.random.default_rng(9) if kw else None)
            got = metrics.apply_compression(perf, size, prune, arch, gen())
            want = ref_metrics.apply_compression(perf, size, prune, arch,
                                                 gen())
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- traffic panels

def test_arrivals_per_hour_equals_reference():
    wl = generate_empirical_workload(4, 10 * 86400.0)
    for arr in (wl.arrival, wl.arrival[:300]):
        got = trace.arrivals_per_hour(arr)
        assert got.shape == (7, 24)
        np.testing.assert_array_equal(got, ref_trace.arrivals_per_hour(arr))


def records(seed=1):
    """Records of a short run, every seventh task marked stranded (its
    start NaN: it never transfers)."""
    wl = generate_empirical_workload(seed, H)
    rec = experiment.run_experiment(
        experiment.ExperimentSpec("t", horizon_s=H, workload=wl),
        device="cpu").records
    start = rec.start.copy()
    start[::7] = np.nan
    return dataclasses.replace(rec, start=start)


@pytest.mark.parametrize("kw", [{}, {"bin_s": 900.0, "horizon_s": H,
                                     "tcp_overhead": 1.0}])
def test_network_traffic_equals_reference(kw):
    rec = records()
    rrec = ref_trace.TaskRecords(**dataclasses.asdict(rec))
    got, want = trace.network_traffic(rec, **kw), \
        ref_trace.network_traffic(rrec, **kw)
    assert set(got) == set(want) == {"edges", "read", "write"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["read"].sum() > 0


# ---------------------------------------------------- run_feedback_simulation

def parity_inputs():
    """A whole-second workload and an explicit fleet with seasonal
    amplitude 0, as numpy arrays both packages take."""
    plat = M.PlatformConfig()
    wl = whole_seconds(generate_empirical_workload(0, H), plat.datastore)
    fl = ref_metrics.pack_fleet(ref_rt.make_model_fleet(
        np.random.default_rng(1), 3, drift_scale=300.0))
    fl[:, ref_metrics.FLEET_SEAS_AMP] = 0.0
    return wl, fl


def test_feedback_spec_and_result_equal_reference(monkeypatch):
    """The spec built field for field as the reference's wrapper builds it
    (the engine aside), the result the port's own ``run_experiment`` of it,
    and equal to the reference's numpy engine on the same workload."""
    wl, fl = parity_inputs()
    rwl = RM.Workload(**{f.name: getattr(wl, f.name)
                         for f in dataclasses.fields(wl)})
    specs = {}
    ref_run = ref_exp.run_experiment

    def ref_capture(spec, params=None):
        specs["ref"] = spec
        return ref_run(dataclasses.replace(spec, workload=rwl), params)

    monkeypatch.setattr(ref_exp, "run_experiment", ref_capture)
    want = ref_rt.run_feedback_simulation(
        None, 5, H, trigger=ref_rt.TriggerSpec(**TRIGGER),
        fleet=ref_rt.FleetSpec(params=fl))
    port_run = experiment.run_experiment

    def port_capture(spec, params=None, device=None):
        specs["port"] = spec
        res = port_run(spec, params, device)
        specs["port_res"] = res
        return res

    monkeypatch.setattr(experiment, "run_experiment", port_capture)
    got = runtime.run_feedback_simulation(
        None, 5, H, trigger=runtime.TriggerSpec(**TRIGGER),
        fleet=runtime.FleetSpec(params=fl), workload=wl, device="cpu")

    ps, rs = specs["port"], specs["ref"]
    assert [f.name for f in dataclasses.fields(ps)] == \
        [f.name for f in dataclasses.fields(rs)]
    for f in dataclasses.fields(ps):
        a, b = getattr(ps, f.name), getattr(rs, f.name)
        if f.name == "engine":
            assert (a, b) == ("torch", "numpy")
        elif f.name == "workload":
            assert a is wl and b is None
        elif f.name in ("platform", "fleet", "trigger"):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            assert da.keys() == db.keys()
            for k in da:
                np.testing.assert_array_equal(np.asarray(da[k], object),
                                              np.asarray(db[k], object), k)
        else:
            assert a == b, f.name

    res = specs["port_res"]
    assert got.records is res.records and got.lifecycle is res.lifecycle
    assert (got.n_exogenous, got.n_triggered) == \
        (want.n_exogenous, want.n_triggered)
    assert got.n_triggered >= 3
    assert got.retrain_times == want.retrain_times
    np.testing.assert_array_equal(got.perf_timeline, want.perf_timeline)
    for k, v in dataclasses.asdict(got.records).items():
        np.testing.assert_array_equal(v, getattr(want.records, k), k)


def test_feedback_takes_a_legacy_rule_and_the_defaults():
    """A ``TriggerRule`` becomes its spec at ``window_s``; without a fleet
    one of ``n_models`` is sampled at ``drift_scale``."""
    wl, _ = parity_inputs()
    seen = {}
    run = experiment.run_experiment

    def capture(spec, params=None, device=None):
        seen["spec"] = spec
        return run(spec, params, device)

    rule = runtime.TriggerRule(drift_threshold=0.02, cooldown_s=1800.0)
    params = fitting.SimulationParams.load(str(ARTIFACT), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(experiment, "run_experiment", capture)
        res = runtime.run_feedback_simulation(
            params, 5, H, n_models=2, window_s=1200.0, drift_scale=300.0,
            trigger=rule, workload=wl, device="cpu")
    spec = seen["spec"]
    assert spec.trigger == rule.to_spec(interval_s=1200.0)
    assert spec.fleet == runtime.FleetSpec(n_models=2, drift_scale=300.0)
    assert res.perf_timeline.shape == (2, int(H // 1200.0))
