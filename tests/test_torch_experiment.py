"""The port's experiment layer (``repro_torch.core.experiment``/``engines``)
and CLI against the JAX package, on the CPU.

On pinned integer-time workloads (exact in f32 and f64) the port's
``run_experiment`` and ``Sweep`` summaries equal the reference's exact
numpy engine (``engine="numpy"``) **exactly**, every key but the two wall
clock ones, at 1 and 4 replicas, with and without an operational scenario
(failures with retries, a maintenance window, an SLO). The scenario draws
are numpy's in both packages, seeded ``seed + 1000 r`` for replica ``r``.
An unregistered engine and a ``source`` that is not a ``TraceSource`` are
refused (streaming has its own twins, ``tests/test_torch_stream.py``). The
CLI runs the whole fit -> synthesize -> simulate path on the CPU at a small
size.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.core import model as RM
from repro.ops import FailureModel as RefFailureModel
from repro.ops import MaintenanceWindows as RefMaintenance
from repro.ops import RetryPolicy as RefRetry
from repro.ops import Scenario as RefScenario
from repro.ops import SLOConfig as RefSLO
from repro_torch.core import engines, experiment
from repro_torch.core import model as M
from repro_torch.core.fitting import SimulationParams
from repro_torch.ops.accounting import SLOConfig
from repro_torch.ops.capacity import MaintenanceWindows
from repro_torch.ops.failures import FailureModel, RetryPolicy
from repro_torch.ops.scenario import Scenario
from test_des_engines import make_workload

ROOT = Path(__file__).resolve().parents[1]
HORIZON = 300.0
WALL_KEYS = ("wall_s", "pipelines_per_s")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_workload(seed, n=60):
    return make_workload(np.random.default_rng(seed), n, integer_time=True,
                         horizon=HORIZON)


def port_workload(w):
    return M.Workload(**{f.name: getattr(w, f.name)
                         for f in dataclasses.fields(M.Workload)})


def platforms(a=3, b=2):
    return (RM.PlatformConfig(resources=(RM.ResourceConfig("a", a),
                                         RM.ResourceConfig("b", b, 3.0))),
            M.PlatformConfig(resources=(M.ResourceConfig("a", a),
                                        M.ResourceConfig("b", b, 3.0))))


def scenarios():
    """(reference, port) failure + maintenance + SLO scenarios."""
    kw = dict(p_fail_by_type=(0.3,) * M.N_TASK_TYPES)
    retry = dict(max_retries=2, base_s=4.0, mult=2.0, cap_s=16.0)
    win = ((50.0, 150.0, 0, 0.5),)
    return (RefScenario(name="fail", slo=RefSLO(),
                        capacity=RefMaintenance(windows=win),
                        failures=RefFailureModel(retry=RefRetry(**retry),
                                                 **kw)),
            Scenario(name="fail", slo=SLOConfig(),
                     capacity=MaintenanceWindows(windows=win),
                     failures=FailureModel(retry=RetryPolicy(**retry), **kw)))


def assert_same_summary(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in WALL_KEYS:
            continue
        g, w = got[k], want[k]
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), k
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("n_replicas", [1, 4])
@pytest.mark.parametrize("with_scenario", [False, True])
@pytest.mark.parametrize("policy", [ref_des.POLICY_FIFO, ref_des.POLICY_SJF])
def test_run_experiment_equals_numpy_engine(n_replicas, with_scenario,
                                            policy):
    w = ref_workload(10 * policy + n_replicas)
    rplat, pplat = platforms()
    rscen, pscen = scenarios() if with_scenario else (None, None)
    want = ref_exp.run_experiment(ref_exp.ExperimentSpec(
        name="x", platform=rplat, horizon_s=HORIZON, policy=policy, seed=3,
        n_replicas=n_replicas, engine="numpy", workload=w, scenario=rscen))
    got = experiment.run_experiment(experiment.ExperimentSpec(
        name="x", platform=pplat, horizon_s=HORIZON, policy=policy, seed=3,
        n_replicas=n_replicas, workload=port_workload(w), scenario=pscen),
        device="cpu")
    assert_same_summary(got.summary, want.summary)
    if n_replicas > 1:
        for g, s in zip(got.replica_summaries, want.replica_summaries):
            assert_same_summary(g, s)
    assert np.array_equal(got.records.start, want.records.start,
                          equal_nan=True)
    assert np.array_equal(got.records.finish, want.records.finish,
                          equal_nan=True)


def test_sweep_equals_numpy_sweep_point_for_point():
    """A policy x learning-capacity grid with a scenario axis runs as one
    batched call and equals the reference's numpy sweep."""
    w = ref_workload(99, n=50)
    rplat, pplat = platforms()
    rscen, pscen = scenarios()
    axes = {"policy": [ref_des.POLICY_FIFO, ref_des.POLICY_PRIORITY,
                       ref_des.POLICY_SJF],
            "capacity:b": [1, 3]}
    want = ref_exp.Sweep(ref_exp.ExperimentSpec(
        name="g", platform=rplat, horizon_s=HORIZON, engine="numpy",
        workload=w, scenario=rscen, n_replicas=2), axes).run()
    sweep = experiment.Sweep(experiment.ExperimentSpec(
        name="g", platform=pplat, horizon_s=HORIZON,
        workload=port_workload(w), scenario=pscen, n_replicas=2), axes)
    calls = []
    orig = engines.vdes.simulate_ensemble

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    engines.vdes.simulate_ensemble = counted
    try:
        got = sweep.run(device="cpu")
    finally:
        engines.vdes.simulate_ensemble = orig
    assert len(calls) == 1 and len(got) == len(want) == 6
    for g, s in zip(got, want):
        assert g.experiment.name == s.experiment.name
        assert_same_summary(g.summary, s.summary)


def test_ragged_platform_grid_pads_onto_one_batch():
    """A 'platform' axis mixing 2 and 3 resources: inert pools pad the
    smaller one, and each point equals its own numpy run. As in the
    reference's batched engine, the padded point's utilization also lists
    the inert pool, at 0.0."""
    w = ref_workload(5, n=40)
    r2, p2 = platforms()
    r3 = RM.PlatformConfig(resources=r2.resources + (RM.ResourceConfig("c", 2),))
    p3 = M.PlatformConfig(resources=p2.resources + (M.ResourceConfig("c", 2),))
    want = [ref_exp.run_experiment(ref_exp.ExperimentSpec(
        name="p", platform=p, horizon_s=HORIZON, engine="numpy", workload=w))
        for p in (r2, r3)]
    got = experiment.Sweep(experiment.ExperimentSpec(
        name="p", horizon_s=HORIZON, workload=port_workload(w)),
        {"platform": [p2, p3]}).run(device="cpu")
    util = got[0].summary["utilization"]
    assert list(util) == ["compute_cluster", "learning_cluster", "datastore"]
    assert util.pop("datastore") == 0.0
    for g, s in zip(got, want):
        assert_same_summary(g.summary, s.summary)


@pytest.mark.parametrize("field,value", [
    ("source", object()), ("engine", "jax")])
def test_unported_fields_raise(field, value):
    """An engine the port does not register (the reference's ``"jax"``)
    and a ``source`` that is not a ``TraceSource`` are refused, naming the
    field."""
    spec = experiment.ExperimentSpec(
        name="x", horizon_s=HORIZON,
        workload=port_workload(ref_workload(1, n=10)))
    spec = dataclasses.replace(spec, **{field: value})
    err = ValueError if field == "engine" else TypeError
    with pytest.raises(err, match=field):
        experiment.run_experiment(spec, device="cpu")


def test_synthesized_ensemble_from_artifact():
    """The synthesis path through the engine: replicas drawn from one
    generator seeded ``seed`` (the same seed gives the same result), every
    synthesized pipeline finished, and the reference's ensemble summary
    keys."""
    params = SimulationParams.load(str(ROOT / "artifacts" /
                                       "pipesim_params.npz"), device="cpu")
    spec = experiment.ExperimentSpec(name="s", horizon_s=1800.0,
                                     n_replicas=2, seed=4)
    a = experiment.run_experiment(spec, params, device="cpu")
    b = experiment.run_experiment(spec, params, device="cpu")
    assert set(a.summary) == {"mean_wait_s", "p95_wait_s",
                              "wait_ci95_halfwidth", "wall_s", "n_replicas"}
    assert a.summary["mean_wait_s"] == b.summary["mean_wait_s"]
    assert np.isfinite(a.records.finish).all()
    assert sum(s["n_pipelines"] for s in a.replica_summaries) > 20


def test_result_save(tmp_path):
    res = experiment.run_experiment(experiment.ExperimentSpec(
        name="x", horizon_s=HORIZON,
        workload=port_workload(ref_workload(2, n=20))), device="cpu")
    res.save(str(tmp_path))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["summary"]["n_pipelines"] == res.summary["n_pipelines"]
    assert (tmp_path / "records.npz").exists()


def test_cli_prints_summary_on_cpu(tmp_path):
    """The paper's CLI path on the CPU: fit on half a day of ground truth,
    synthesize 0.2 days, simulate, print the summary JSON; the fit is
    cached to ``--params-cache`` and read back by a second run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cache = tmp_path / "params.npz"
    outs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate",
             "--device", "cpu", "--days", "0.5", "--horizon-days", "0.2",
             "--params-cache", str(cache)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        text = proc.stdout
        outs.append((text, json.loads(text[text.index("{"):])))
    assert "[fit]" in outs[0][0] and "[params] loaded" in outs[1][0]
    for _, summary in outs:
        assert summary["n_pipelines"] > 0
        assert np.isfinite(summary["mean_wait_s"])
    assert outs[0][1]["mean_wait_s"] == outs[1][1]["mean_wait_s"]
