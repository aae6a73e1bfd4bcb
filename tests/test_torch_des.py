"""The port's numpy heap engine (``repro_torch.core.des.simulate``) against
the reference's (``repro.core.des.simulate``), on the CPU, and the port's
users of it: the ``"numpy"`` engine, ``profile_numpy``, ``--engine numpy``
and the parity auditor's mirror rule.

Both engines run numpy in f64 with the f32 stages computed in f32, so they
agree **bit for bit on any workload**, not only on the whole-second ones
the batched engine's twins need: every case here runs the ground-truth
generator's non-integer times, and every ``SimTrace`` field must be equal,
NaN equal to NaN. Each case's stage inputs are compiled once by the port's
host side and handed to both engines. The windowed cut (``time_budget``,
``return_state``, ``resume``) must reproduce the uninterrupted run in both
packages. On ``chip_smoke.py`` phase 13's and 14(b)'s whole-second
ensembles the heap engine equals the port's batched engine on the CPU,
which closes the loop inside the port (phase 22 does the same against the
card's runs).
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.core import model as RM
from repro.obs import profile as ref_profile
from repro.ops import FailureModel as RefFailureModel
from repro.ops import MaintenanceWindows as RefMaintenance
from repro.ops import Scenario as RefScenario
from repro.ops import SLOConfig as RefSLO
from repro_torch.analysis.ast_audit import audit_tree
from repro_torch.core import batching, des, engines, experiment, vdes
from repro_torch.core import model as M
from repro_torch.core.runtime import FleetSpec, TriggerSpec
from repro_torch.core.workload import generate_empirical_workload
from repro_torch.obs import profile_numpy
from repro_torch.obs.probes import ProbeSpec, compile_probe
from repro_torch.ops.accounting import SLOConfig
from repro_torch.ops.capacity import MaintenanceWindows, ReactiveController
from repro_torch.ops.failures import FailureModel
from repro_torch.ops.scenario import Scenario, compile_fleet
from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                     RepairSpec, TopologySpec,
                                     compile_reliability)
from test_des_engines import make_workload

ROOT = Path(__file__).resolve().parents[1]
H = 0.1 * 86400.0
LEARNING_CAP = 8            # small, so queues form
SEED = 11
WALL_KEYS = ("wall_s", "pipelines_per_s")
REL_SPEC = ReliabilitySpec(
    topology=TopologySpec(zones=2, racks_per_zone=2),
    outages=DomainOutageModel(zone_mtbf_s=H / 2.0, rack_mtbf_s=H / 4.0,
                              mttr_s=H / 24.0),
    repair=RepairSpec(crews=1))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def platforms():
    """The port's and the reference's default platform with a small
    learning cluster."""
    return tuple(mod.PlatformConfig().with_capacity("learning_cluster",
                                                    LEARNING_CAP)
                 for mod in (M, RM))


def ref_workload(wl):
    return RM.Workload(**{f.name: getattr(wl, f.name)
                          for f in dataclasses.fields(wl)})


def build(case, seed=SEED):
    """One case's workload (ground truth, non-integer times), policy and
    stage inputs, compiled by the port's host side."""
    plat = platforms()[0]
    wl = generate_empirical_workload(seed, H)
    policy = des.POLICY_NAMES.index(case) if case in des.POLICY_NAMES \
        else des.POLICY_FIFO
    flaky = FailureModel(p_fail_by_type=(0.25,) * M.N_TASK_TYPES)
    scen = {"scenario": Scenario(
                capacity=MaintenanceWindows(((1800.0, 5400.0, 1, 0.0),)),
                failures=FailureModel(p_fail_by_type=(0.35,) * 6,
                                      resample_service=True,
                                      fail_holds_frac=0.5)),
            "controller": Scenario(failures=flaky, controller=(
                ReactiveController(high_watermark=0.3, step=0.5,
                                   max_scale=3.0, interval_s=600.0,
                                   cooldown_s=1200.0)))}
    scen["full_stack"] = scen["controller"]
    scen["probe"] = scen["reliability"] = Scenario(failures=flaky)
    if case == "scenario":
        policy = des.POLICY_PRIORITY
    if case == "controller":
        policy = des.POLICY_SJF
    kw = {}
    if case in ("fleet", "full_stack"):
        kw["fleet"], wl = compile_fleet(
            FleetSpec(n_models=4, drift_scale=200.0),
            TriggerSpec(drift_threshold=0.03, cooldown_s=1800.0,
                        obs_noise=0.005, interval_s=900.0,
                        retrain_durations=(301.5, 60.25, 30.75)),
            wl, plat, H, seed=seed)
    if case in ("reliability", "full_stack"):
        kw["reliability"] = compile_reliability(REL_SPEC, wl, plat, H,
                                                seed=seed)
    if case in ("probe", "full_stack"):
        kw["probe"] = compile_probe(
            ProbeSpec(interval_s=900.0), H,
            n_models=kw["fleet"].n_models if "fleet" in kw else 0)
    if case in scen:
        kw["scenario"] = scen[case].compile(wl, plat, H, seed=seed,
                                            policy=policy, device="cpu")
    return wl, policy, kw


def run_both(wl, policy, kw, **hooks):
    plat, rplat = platforms()
    return (des.simulate(wl, plat, policy, **kw, **hooks),
            ref_des.simulate(ref_workload(wl), rplat, policy, **kw, **hooks))


def assert_same_trace(got, want):
    """Every SimTrace field equal: arrays bit for bit (NaN == NaN) with the
    same dtype and shape, the rest by value."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for k in names:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), k
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                               w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, (k, g, w)


def _acted(case, tr):
    """The case's stage acted in the run (a vacuous twin proves nothing)."""
    if case == "scenario":
        return tr.attempts.max() > 1 and tr.att_start is not None
    if case == "controller":
        return tr.ctrl_times.shape[0] > 0
    if case == "fleet":
        return (tr.fleet_kind == des.FLEET_ACT_REDEPLOY).any()
    if case == "probe":
        return not np.isnan(tr.probe_vals).all()
    if case == "reliability":
        return tr.rel_times.shape[0] > 0
    if case == "full_stack":
        return all(_acted(c, tr) for c in ("controller", "fleet", "probe",
                                           "reliability"))
    return True


CASES = list(des.POLICY_NAMES) + ["scenario", "controller", "fleet", "probe",
                                  "reliability", "full_stack"]


@pytest.mark.parametrize("case", CASES)
def test_heap_engine_equals_reference(case):
    wl, policy, kw = build(case)
    assert (wl.arrival[np.isfinite(wl.arrival)] % 1.0 != 0.0).any()
    got, want = run_both(wl, policy, kw)
    assert_same_trace(got, want)
    assert _acted(case, got), case
    done = got.completed if got.completed is not None \
        else ~np.isnan(got.finish).any(1)
    assert done.sum() > 0 and got.waves > 0


@pytest.mark.parametrize("package", ["port", "reference"])
def test_windowed_cut_resumes_to_the_uninterrupted_run(package):
    """``time_budget`` with ``return_state``, twice, then ``resume`` to
    the end: equal to the uninterrupted run in each package (the port's
    also to the reference's uninterrupted run)."""
    wl, policy, kw = build("full_stack")
    plat, rplat = platforms()
    if package == "port":
        def sim(**hooks):
            return des.simulate(wl, plat, policy, **kw, **hooks)
    else:
        rwl = ref_workload(wl)

        def sim(**hooks):
            return ref_des.simulate(rwl, rplat, policy, **kw, **hooks)
    whole = sim()
    _, state = sim(time_budget=H / 3.0, return_state=True)
    first = state["wave"]
    _, state = sim(time_budget=2.0 * H / 3.0, return_state=True,
                   resume=state)
    assert 0 < first < state["wave"] < whole.waves
    rest = sim(resume=state)
    assert_same_trace(rest, whole)
    if package == "port":
        assert_same_trace(rest, run_both(wl, policy, kw)[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_station_fifo_schedule_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ready = rng.uniform(0.0, 1000.0, 300)
    service = rng.exponential(30.0, 300)
    cap_times = np.array([0.0, 150.5, 400.25, 700.75])
    cap_vals = np.array([1, 2, 2, 5])
    got = des.single_station_fifo_schedule(ready, service, cap_times,
                                           cap_vals)
    want = ref_des.single_station_fifo_schedule(ready, service, cap_times,
                                                cap_vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="additions"):
        des.single_station_fifo_schedule(ready, service, cap_times,
                                         cap_vals[::-1])


@pytest.mark.parametrize("which", ["oracle", "fullstack"])
def test_heap_engine_equals_cpu_batched_engine(chip_smoke, which):
    """``chip_smoke.py`` phase 22(a)/(b) with the CPU path in the card's
    place: phase 13's and 14(b)'s ensembles through the port's batched
    engine on the CPU and the heap engine, replica by replica."""
    if which == "oracle":
        ens, keys, stages, n = (chip_smoke.oracle_ensemble(),
                                chip_smoke.HEAP_ORACLE_KEYS, False,
                                chip_smoke.HEAP_ORACLE_COLUMNS)
    else:
        ens, keys, stages, n = (chip_smoke.fullstack_oracle_ensemble(),
                                chip_smoke.HEAP_FSO_KEYS, True,
                                chip_smoke.HEAP_FSO_COLUMNS)
    cols, caps, pols = ens[:3]
    out = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                 capacities=caps, policies=pols,
                                 device="cpu")
    unpadded, compared, _ = chip_smoke.heap_vs_batched(out, ens, keys, n,
                                                       stages=stages)
    assert unpadded >= 1
    assert compared == {"oracle": 28, "fullstack": 57}[which]


# ------------------------------------------------------- the engine's users

def integer_workload(seed, n=60, horizon=300.0):
    """A pinned whole-second workload: f32 and f64 agree on it, so the
    batched engine equals the heap engine exactly."""
    w = make_workload(np.random.default_rng(seed), n, integer_time=True,
                      horizon=horizon)
    return M.Workload(**{f.name: getattr(w, f.name)
                         for f in dataclasses.fields(M.Workload)})


def two_pools(mod):
    return mod.PlatformConfig(resources=(mod.ResourceConfig("a", 3),
                                         mod.ResourceConfig("b", 2, 3.0)))


def scenarios():
    """(reference, port) failure + maintenance + SLO scenarios."""
    kw = dict(p_fail_by_type=(0.3,) * M.N_TASK_TYPES)
    win = ((50.0, 150.0, 0, 0.5),)
    return (RefScenario(name="fail", slo=RefSLO(),
                        capacity=RefMaintenance(windows=win),
                        failures=RefFailureModel(resample_service=True, **kw)),
            Scenario(name="fail", slo=SLOConfig(),
                     capacity=MaintenanceWindows(windows=win),
                     failures=FailureModel(resample_service=True, **kw)))


def assert_same_summary(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in WALL_KEYS:
            continue
        g, w = got[k], want[k]
        if isinstance(w, dict):
            assert_same_summary(g, w)
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), k
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("n_replicas", [1, 3])
@pytest.mark.parametrize("with_scenario", [False, True])
def test_numpy_engine_equals_reference_numpy_engine(n_replicas,
                                                    with_scenario):
    """``run_experiment(engine="numpy")`` on a pinned ground-truth
    workload (non-integer times) equals the reference's ``NumpyEngine``:
    every summary key but the wall, the replicas' summaries and the
    records."""
    w = generate_empirical_workload(5, 0.05 * 86400.0)
    rscen, pscen = scenarios() if with_scenario else (None, None)
    common = dict(name="x", horizon_s=0.05 * 86400.0, policy=1, seed=3,
                  n_replicas=n_replicas, engine="numpy")
    want = ref_exp.run_experiment(ref_exp.ExperimentSpec(
        platform=two_pools(RM).with_capacity("b", 1), workload=ref_workload(w),
        scenario=rscen, **common))
    got = experiment.run_experiment(experiment.ExperimentSpec(
        platform=two_pools(M).with_capacity("b", 1), workload=w,
        scenario=pscen, **common), device="cpu")
    assert_same_summary(got.summary, want.summary)
    for g, s in zip(got.replica_summaries or [], want.replica_summaries or []):
        assert_same_summary(g, s)
    for k in ("start", "finish"):
        np.testing.assert_array_equal(getattr(got.records, k),
                                      getattr(want.records, k))


def test_numpy_engine_full_stack_equals_reference_numpy_engine():
    """The full stack through both packages' ``NumpyEngine`` on a pinned
    workload: the lifecycle and availability blocks too."""
    from repro.core.runtime import FleetSpec as RefFleet
    from repro.core.runtime import TriggerSpec as RefTrigger
    from repro.obs.probes import ProbeSpec as RefProbe
    from repro.ops.capacity import ReactiveController as RefController
    from repro.reliability import ReliabilitySpec as RefRel
    from repro.reliability import SpotPoolSpec as RefSpot
    from repro_torch.reliability import SpotPoolSpec
    w = generate_empirical_workload(6, H)
    trig = dict(drift_threshold=0.03, cooldown_s=1800.0, obs_noise=0.005,
                interval_s=900.0, retrain_durations=(301.5, 60.25, 30.75))
    rel = dict(spot=dict(frac=0.2, evict_mtbe_s=H / 3.0))
    specs = []
    for mod, exp, fleet, trigger, probe, ctrl, relspec, spot, wl in (
            (RM, ref_exp, RefFleet, RefTrigger, RefProbe, RefController,
             RefRel, RefSpot, ref_workload(w)),
            (M, experiment, FleetSpec, TriggerSpec, ProbeSpec,
             ReactiveController, ReliabilitySpec, SpotPoolSpec, w)):
        specs.append(exp.ExperimentSpec(
            name="fs", platform=mod.PlatformConfig().with_capacity(
                "learning_cluster", LEARNING_CAP),
            horizon_s=H, seed=2, n_replicas=2, engine="numpy", workload=wl,
            fleet=fleet(n_models=3, drift_scale=300.0),
            trigger=trigger(**trig), probe=probe(interval_s=900.0),
            reliability=relspec(spot=spot(**rel["spot"])),
        ).with_(controller=ctrl(interval_s=900.0)))
    want = ref_exp.run_experiment(specs[0])
    got = experiment.run_experiment(specs[1], device="cpu")
    assert_same_summary(got.summary, want.summary)
    for g, s in zip(got.replica_summaries, want.replica_summaries):
        assert "lifecycle" in s and "availability" in s
        assert_same_summary(g, s)


def test_sweep_engine_axis_runs_both_engines():
    """A ``Sweep`` with an ``"engine"`` axis: the ``"torch"`` point is one
    batched call, the ``"numpy"`` point runs the heap engine, and on a
    whole-second workload the two summaries are equal."""
    scen = Scenario(name="fail", slo=SLOConfig(),
                    capacity=MaintenanceWindows(((50.0, 150.0, 0, 0.5),)),
                    failures=FailureModel(
                        p_fail_by_type=(0.3,) * M.N_TASK_TYPES))
    sweep = experiment.Sweep(experiment.ExperimentSpec(
        name="e", platform=two_pools(M), horizon_s=300.0,
        workload=integer_workload(7), scenario=scen, n_replicas=2),
        {"engine": ["torch", "numpy"]})
    calls = []
    orig = engines.vdes.simulate_ensemble

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    engines.vdes.simulate_ensemble = counted
    try:
        res = sweep.run(device="cpu")
    finally:
        engines.vdes.simulate_ensemble = orig
    assert len(calls) == 1 and len(res) == 2
    assert [r.experiment.engine for r in res] == ["torch", "numpy"]
    assert_same_summary(res[0].summary, res[1].summary)


def with_empty_task(w):
    """``w`` with one more task column, empty (task type -1), as a
    workload of a larger ``max_tasks`` pads its shorter pipelines."""
    return M.Workload(**{
        f.name: (np.pad(getattr(w, f.name), ((0, 0), (0, 1)),
                        constant_values=-1 if f.name == "task_type" else 0)
                 if getattr(w, f.name).ndim == 2 else getattr(w, f.name))
        for f in dataclasses.fields(M.Workload)})


@pytest.mark.parametrize("with_scenario", [False, True])
def test_ragged_task_grid_stays_one_batch(with_scenario):
    """Pinned workloads of differing ``max_tasks``: ``"torch"`` pads the
    shorter ones with empty task columns and runs the grid as one batched
    call, with no warning and no host engine. Each point equals the heap
    engine's run of it: the summaries, and the records (whose task columns
    are the point's own)."""
    wls = [integer_workload(8), with_empty_task(integer_workload(9))]
    assert wls[0].max_tasks + 1 == wls[1].max_tasks
    scen = Scenario(name="fail", slo=SLOConfig(),
                    capacity=MaintenanceWindows(((50.0, 150.0, 0, 0.5),)),
                    failures=FailureModel(
                        p_fail_by_type=(0.3,) * M.N_TASK_TYPES))
    specs = [experiment.ExperimentSpec(
        name=f"r{i}", platform=two_pools(M), horizon_s=300.0, workload=w,
        scenario=scen if with_scenario else None)
        for i, w in enumerate(wls)]
    calls = []
    orig = engines.vdes.simulate_ensemble

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    engines.vdes.simulate_ensemble = counted
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = engines.get_engine("torch", "cpu").run_sweep(specs)
    finally:
        engines.vdes.simulate_ensemble = orig
    want = engines.get_engine("numpy", "cpu").run_sweep(specs)
    assert len(calls) == 1 and len(got) == 2
    for g, s in zip(got, want):
        assert_same_summary(g.summary, s.summary)
        for k in ("start", "finish"):
            np.testing.assert_array_equal(getattr(g.records, k),
                                          getattr(s.records, k))


def test_profile_numpy_keys_and_waves():
    wl, policy, kw = build("scenario")
    plat, rplat = platforms()
    got = profile_numpy(wl, plat, policy, scenario=kw["scenario"],
                        repeats=2)
    want = ref_profile.profile_numpy(ref_workload(wl), rplat, policy,
                                     scenario=kw["scenario"], repeats=1)
    assert set(got) == set(want) == {"wall_s", "waves", "waves_per_s"}
    assert got["waves"] == want["waves"] == des.simulate(
        wl, plat, policy, scenario=kw["scenario"]).waves
    assert got["wall_s"] > 0 and got["waves_per_s"] > 0


def test_numpy_engine_without_card_raises_unless_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = experiment.ExperimentSpec(name="x", horizon_s=300.0,
                                     workload=integer_workload(1, n=10),
                                     engine="numpy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.run_experiment(spec)
    res = experiment.run_experiment(spec, device="cpu")
    assert res.summary["n_pipelines"] == 10


def test_cli_engine_numpy_on_cpu(tmp_path):
    """``--engine numpy`` with the committed fit: the same synthesized
    workload as ``--engine torch`` on the same device, simulated by the
    heap engine."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cache = tmp_path / "params.npz"
    shutil.copy(ROOT / "artifacts" / "pipesim_params.npz", cache)
    out = {}
    for engine in ("numpy", "torch"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate",
             "--device", "cpu", "--horizon-days", "0.1", "--engine", engine,
             "--params-cache", str(cache)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        text = proc.stdout
        out[engine] = json.loads(text[text.index("{"):])
    assert out["numpy"]["n_pipelines"] == out["torch"]["n_pipelines"] > 0
    assert np.isfinite(out["numpy"]["mean_wait_s"])


# ------------------------------------------------- the auditor's mirror rule

@pytest.mark.parametrize("drop", [None, "_fleet_stage", "_select_events"])
def test_auditor_reads_the_ports_mirror_markers(tmp_path, drop):
    """The AST pass reads the markers from the port's own ``des.py``: on
    the real sources it finds no mirror finding, and with one marker
    removed it reports ``mirror-missing`` for that stage."""
    files = {"src/repro_torch/core/vdes.py": None,
             "src/repro_torch/core/des.py": None,
             "src/repro/core/vdes.py": None}
    for rel in files:
        text = (ROOT / rel).read_text()
        if drop is not None and rel == "src/repro_torch/core/des.py":
            marker = f"# mirror: vdes.{drop}"
            assert marker in text
            text = text.replace(marker, "# (marker removed)")
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    got = [f for f in audit_tree(str(tmp_path))
           if f.rule.startswith("mirror-")]
    if drop is None:
        assert got == []
    else:
        assert [(f.rule, f.file) for f in got] == [
            ("mirror-missing", "src/repro_torch/core/vdes.py")]
        assert drop in got[0].message
