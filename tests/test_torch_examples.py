"""The ten examples of the port (``examples/torch/*.py``) on the CPU, at
small sizes, against the JAX package.

Each example is loaded by its path and its ``main(device="cpu", ...)``
called. Where an example goes through ``ExperimentSpec``/``Sweep``
(capacity planning, the reliability frontier, the autoscaling scenarios,
the model lifecycle, observability), its table on a pinned whole-second
``workload=`` equals, **exactly**, the table that the reference example's
own print loop reads from the reference's numpy engine (``des.simulate``)
on the same spec: the fleet runs (pinned drift processes with no seasonal
term, pinned retraining durations) are held against that engine only, as
the reference's JAX engine fails on a fleet (ROADMAP queue 3, a). The
scheduler comparison and the accelerator platform are held against the
reference's ``des.simulate`` on the same workload. The quickstart and the
replay return every field the reference prints, the replay bit for bit
(drift 0.0); the training run takes a few steps with a fault, its loss
falls and it restarts once (no reference: its ``run_training`` fails,
queue 3, d).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.core import model as RM
from repro.core import runtime as ref_rt
from repro.core import trace as ref_trace
from repro.obs import ProbeSpec as RefProbe
from repro.obs import build_spans as ref_build_spans
from repro.ops import (FailureModel as RefFailureModel,
                       MaintenanceWindows as RefMaintenance,
                       OutageModel as RefOutage,
                       ReactiveAutoscaler as RefReactiveAutoscaler,
                       ReactiveController as RefController,
                       Scenario as RefScenario,
                       ScheduledAutoscaler as RefScheduled,
                       SLOConfig as RefSLO)
from repro.reliability import (DomainOutageModel as RefDomainOutage,
                               ReliabilitySpec as RefReliability,
                               RepairSpec as RefRepair,
                               SpotPoolSpec as RefSpot,
                               TopologySpec as RefTopology)
from repro_torch import configs as CN
from repro_torch.core import model as M
from repro_torch.core.runtime import FleetSpec
from repro_torch.core.workload import generate_empirical_workload, whole_seconds
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
RETRAIN = (600.0, 60.0, 30.0)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pinned(seed, horizon_s, plat=None):
    """A whole-second ground-truth workload, as the port's and the
    reference's ``Workload``."""
    plat = plat or M.PlatformConfig()
    pwl = whole_seconds(generate_empirical_workload(seed, horizon_s),
                        plat.datastore)
    rwl = RM.Workload(**{f.name: getattr(pwl, f.name)
                         for f in dataclasses.fields(pwl)})
    return pwl, rwl


def pinned_fleet(n):
    """``n`` drift processes with no seasonal term (exact in both
    engines), for the port's and the reference's ``FleetSpec``."""
    fl = np.random.default_rng(11).uniform(0.0, 1.0, (n, 6)).astype(
        np.float32)
    fl[:, 0] = np.linspace(0.8, 0.95, n)
    fl[:, 1] = 2e-8
    fl[:, 2] = 1.0 / (14 * 86400.0)
    fl[:, 3] = 0.08
    fl[:, 4] = 0.0
    return (FleetSpec(params=fl, drift_scale=60.0),
            ref_rt.FleetSpec(params=fl, drift_scale=60.0))


def test_fitted_params_loads_the_committed_fit_and_never_writes(
        tmp_path, monkeypatch):
    common = load("_common")
    p = common.fitted_params("cpu")
    assert p.framework_mix.shape[0] == M.N_FRAMEWORKS
    assert common.fitted_params("cpu") is p
    # without the file: a fit in memory, nothing written
    missing = tmp_path / "artifacts" / "pipesim_params.npz"
    monkeypatch.setattr(common, "PARAMS_PATH", str(missing))
    q = common.fitted_params("cpu", days=0.2)
    assert q is not p and torch.isfinite(q.asset_gmm.means).all()
    assert not missing.parent.exists()


def test_capacity_planning_equals_numpy_engine():
    H = 7200.0
    pwl, rwl = pinned(41, H)
    caps = (4, 8, 16)
    got = load("capacity_planning").main(device="cpu", horizon_s=H,
                                         n_replicas=2, capacities=caps,
                                         workload=pwl)
    res = ref_exp.Sweep(ref_exp.ExperimentSpec(
        name="cap", horizon_s=H, engine="numpy", n_replicas=2, seed=7,
        workload=rwl), {"capacity:learning_cluster": list(caps)}).run()
    want = [{"capacity": cap,
             "util": float(np.mean([r["utilization"]["learning_cluster"]
                                    for r in r_.replica_summaries])),
             "mean_wait_s": r_.summary["mean_wait_s"],
             "p95_wait_s": r_.summary["p95_wait_s"],
             "ci95": r_.summary["wait_ci95_halfwidth"]}
            for cap, r_ in zip(caps, res)]
    assert got == want
    assert want[0]["mean_wait_s"] > want[-1]["mean_wait_s"]


def test_reliability_frontier_equals_numpy_engine():
    H = 7200.0
    pwl, rwl = pinned(42, H)
    got = load("reliability_frontier").main(device="cpu", horizon_s=H,
                                            workload=pwl)
    rel = RefReliability(
        topology=RefTopology(zones=2, racks_per_zone=4),
        outages=RefDomainOutage(zone_mtbf_s=H / 2.0, rack_mtbf_s=H / 4.0,
                                mttr_s=H / 24.0),
        time_quantum_s=1.0)
    spots = [None] + [RefSpot(frac=f, evict_mtbe_s=H / 3.0,
                              reclaim_s=H / 48.0) for f in (0.2, 0.4, 0.6)]
    crews = [RefRepair(crews=c, repair_time_s=H / 24.0) for c in (1, 2, 6)]
    res = ref_exp.Sweep(ref_exp.ExperimentSpec(
        name="frontier", horizon_s=H, engine="numpy", seed=7, workload=rwl,
        reliability=rel), {"reliability:spot": spots,
                           "reliability:repair": crews}).run()
    want = []
    for (spot, crew), r in zip(((s, c) for s in spots for c in crews), res):
        a = r.summary["availability"]
        want.append({
            "spot_frac": spot.frac if spot else 0.0, "crews": crew.crews,
            "availability": min(a["availability"].values()),
            "cost": a["cost_split"]["on_demand_cost"]
            + a["cost_split"]["spot_cost"],
            "spot_savings": a["cost_split"]["spot_savings"],
            "max_repair_wait_s": a["repair"]["max_wait_s"],
            "evicted_tasks": (a["eviction"]["evicted_tasks"]
                              if "eviction" in a else 0)})
    assert got == want
    assert len(got) == 12 and any(r["evicted_tasks"] for r in got)


def test_autoscaling_scenarios_equal_numpy_engine():
    H = 0.125 * 86400.0
    pwl, rwl = pinned(43, H)
    got = load("autoscaling_scenarios").main(device="cpu", horizon_s=H,
                                             workload=pwl)
    slo = RefSLO(pipeline_deadline_s=4 * 3600.0, task_wait_slo_s=900.0)
    fails = RefFailureModel(resample_service=True)
    scs = [
        RefScenario(name="static", slo=slo, failures=fails),
        RefScenario(name="maintenance", slo=slo, failures=fails,
                    capacity=RefMaintenance(
                        windows=((2 * 3600.0, 6 * 3600.0, 1, 0.25),))),
        RefScenario(name="outages", slo=slo, failures=fails,
                    outages=RefOutage(mtbf_s=8 * 3600.0, mttr_s=3600.0,
                                      frac_lost=0.33)),
        RefScenario(name="predictive", slo=slo, failures=fails,
                    capacity=RefScheduled(min_scale=0.4, max_scale=1.3)),
        RefScenario(name="reactive", slo=slo, failures=fails,
                    capacity=RefReactiveAutoscaler(
                        interval_s=3600.0, max_scale=2.0, min_scale=0.4)),
    ]
    res = ref_exp.Sweep(ref_exp.ExperimentSpec(
        name="ops", horizon_s=H, seed=7, engine="numpy", workload=rwl,
        platform=RM.PlatformConfig(resources=(
            RM.ResourceConfig("compute_cluster", 48, cost_per_node_hour=1.0),
            RM.ResourceConfig("learning_cluster", 16,
                              cost_per_node_hour=3.0)))),
        {"scenario": scs}).run()
    want = [{"scenario": sc.name, "p95_wait_s": r.summary["p95_wait_s"],
             "deadline_miss_rate": r.summary["deadline_miss_rate"],
             "wait_slo_violation_rate": r.summary["wait_slo_violation_rate"],
             "total_cost": r.summary["total_cost"],
             "util_provisioned": float(np.mean(list(
                 r.summary["utilization_vs_provisioned"].values())))}
            for sc, r in zip(scs, res)]
    assert got == want
    assert len({r["total_cost"] for r in got}) > 1


def test_model_lifecycle_equals_numpy_engine():
    H = 0.25 * 86400.0
    pwl, rwl = pinned(44, H)
    pfl, rfl = pinned_fleet(8)
    got = load("model_lifecycle").main(device="cpu", horizon_s=H,
                                       workload=pwl, fleet=pfl,
                                       retrain_durations=RETRAIN)
    res = ref_exp.Sweep(ref_exp.ExperimentSpec(
        name="lifecycle", horizon_s=H, seed=7, engine="numpy", workload=rwl,
        fleet=rfl, trigger=ref_rt.TriggerSpec(
            interval_s=3600.0, obs_noise=0.005, cooldown_s=4 * 3600.0,
            retrain_durations=RETRAIN)), {
        "trigger:drift_threshold": [0.02, 0.04, 0.08, 0.16],
        "trigger:cooldown_s": [2 * 3600.0, 8 * 3600.0]}).run()
    rows, frontier = [], []
    for r in res:
        lc = r.summary["lifecycle"]
        label = r.experiment.name.split("/", 1)[-1]
        nh = lc["retrain_node_seconds"] / 3600.0
        rows.append({"policy": label, "n_retrained": lc["n_retrained"],
                     "retrain_node_hours": nh,
                     "mean_staleness": lc["mean_staleness"],
                     "final_mean_performance": lc["final_mean_performance"]})
        frontier.append((nh, lc["mean_staleness"], label))
    assert got["rows"] == rows
    frontier.sort()
    best, front = np.inf, []
    for nh, stale, label in frontier:
        if stale < best:
            best = stale
            front.append({"retrain_node_hours": nh, "mean_staleness": stale,
                          "policy": label})
    assert got["frontier"] == front
    lc = res[5].lifecycle
    assert got["drill"] == {
        "n_triggered": lc.n_triggered, "n_retrained": lc.n_retrained,
        "redeploys": [(float(t), int(m)) for t, m in
                      zip(lc.redeploy_times, lc.redeploy_models)]}
    assert sum(r["n_retrained"] for r in rows) > 0


def test_observability_equals_numpy_engine(tmp_path):
    H = 0.25 * 86400.0
    pwl, rwl = pinned(45, H)
    pfl, rfl = pinned_fleet(6)
    got = load("observability").main(device="cpu", horizon_s=H,
                                     workload=pwl, fleet=pfl,
                                     retrain_durations=RETRAIN,
                                     out_dir=str(tmp_path))
    spec = ref_exp.ExperimentSpec(
        name="observability", horizon_s=H, seed=3, engine="numpy",
        workload=rwl, fleet=rfl,
        trigger=ref_rt.TriggerSpec(interval_s=3600.0, obs_noise=0.005,
                                   cooldown_s=4 * 3600.0,
                                   drift_threshold=0.06,
                                   retrain_durations=RETRAIN),
        probe=RefProbe(interval_s=1800.0),
    ).with_(controller=RefController(high_watermark=0.3, step=0.5,
                                     max_scale=3.0, interval_s=3600.0))
    res = ref_exp.run_experiment(spec)
    tl = res.timeline
    s = tl.sampled
    assert got["ticks_sampled"] == int(s.sum()) > 0
    assert got["ticks"] == tl.times.shape[0]
    assert got["channels"] == list(tl.channels)
    want = []
    for i in np.nonzero(s)[0][::4]:
        row = {"t_h": float(tl.times[i] / 3600.0)}
        row.update({c: float(tl.channel(c)[i]) for c in (
            "qlen:compute_cluster", "busy:compute_cluster",
            "cap:compute_cluster", "ctrl_delta:compute_cluster",
            "fleet_min_perf", "fleet_max_staleness")})
        want.append(row)
    assert got["rows"] == want
    kinds = {}
    for sp in ref_build_spans(res.records, name=spec.name):
        kinds[sp["kind"]] = kinds.get(sp["kind"], 0) + 1
    assert got["span_kinds"] == kinds
    for path in got["files"]:
        assert Path(path).parent == tmp_path and Path(path).stat().st_size


def test_scheduler_comparison_equals_des_simulate():
    H = 0.1 * 86400.0
    ex = load("scheduler_comparison")
    pwl, rwl = pinned(46, H, ex.platform())
    got = ex.main(device="cpu", horizon_s=H, workload=pwl)
    rng = np.random.default_rng(0)
    fleet = ref_rt.make_model_fleet(rng, rwl.n)
    staleness = np.array([m.potential_improvement(7 * 86400.0, 0.3)
                          for m in fleet], np.float32)
    rwl.priority = staleness
    plat = RM.PlatformConfig(resources=(
        RM.ResourceConfig("compute_cluster", 16),
        RM.ResourceConfig("learning_cluster", 6)))
    want = []
    for policy, name in ((ref_des.POLICY_FIFO, "fifo"),
                         (ref_des.POLICY_SJF, "sjf"),
                         (ref_des.POLICY_PRIORITY, "staleness")):
        rec = ref_trace.flatten_trace(ref_des.simulate(rwl, plat, policy),
                                      rwl)
        pipe_wait = np.zeros(rwl.n)
        np.add.at(pipe_wait, rec.pipeline, rec.wait)
        want.append({"policy": name, "mean_wait_s": float(rec.wait.mean()),
                     "p95_wait_s": float(np.percentile(rec.wait, 95)),
                     "stale_weighted_wait_s": float(
                         (pipe_wait * staleness).sum() / staleness.sum())})
    assert got == want
    assert got[0]["mean_wait_s"] != got[1]["mean_wait_s"]


def test_accelerator_platform_equals_des_simulate(tmp_path):
    ex = load("accelerator_platform")
    with pytest.raises(SystemExit, match="no dry-run artifacts"):
        ex.main(device="cpu", root=str(tmp_path / "empty"))
    for arch in ("llama3.2-1b", "granite-3-8b"):
        smoke = CN.get_smoke_config(arch)
        dryrun.write_cells([arch], ["train_4k"], root=tmp_path,
                           overrides=dict(n_layers=smoke.n_layers,
                                          d_model=smoke.d_model),
                           log=lambda *a: None)
    got = ex.main(device="cpu", root=str(tmp_path))
    assert sorted(got["medians_s"]) == ["granite-3-8b", "llama3.2-1b"]
    assert all(np.isfinite(v) and v > 0 for v in got["medians_s"].values())
    wl = RM.Workload(**got["workload"])
    want = []
    for n_pods in (2, 4, 8):
        tr = ref_des.simulate(wl, RM.PlatformConfig(resources=(
            RM.ResourceConfig("compute", 1),
            RM.ResourceConfig("tpu_pods", n_pods))))
        wait = tr.wait[:, 0]
        want.append({"pods": n_pods, "mean_wait_h": float(wait.mean() / 3600),
                     "p95_wait_h": float(np.percentile(wait, 95) / 3600)})
    assert got["rows"] == want


def _ref_summary_keys():
    """The keys of the reference's ``summarize`` on a tiny run."""
    wl = RM.Workload(**{f.name: getattr(w, f.name) for w in [
        pinned(47, 1800.0)[0]] for f in dataclasses.fields(RM.Workload)})
    plat = RM.PlatformConfig()
    rec = ref_trace.flatten_trace(ref_des.simulate(wl, plat), wl)
    return set(ref_trace.summarize(rec, plat.capacities, 1800.0))


def test_quickstart_returns_every_field():
    got = load("quickstart").main(device="cpu", days=0.5, horizon_s=10800.0,
                                  em_iters=5)
    assert got["empirical_pipelines"] > 100
    assert np.isfinite(got["mean_interarrival_s"])
    s = got["summary"]
    assert set(s) == _ref_summary_keys()
    assert s["n_pipelines"] > 0 and np.isfinite(s["mean_wait_s"])


def test_replay_trace_is_exact(tmp_path):
    got = load("replay_trace").main(device="cpu", horizon_s=3600.0,
                                    out_dir=str(tmp_path))
    assert set(got) == {
        "pipelines", "orig_mean_wait_s", "orig_p95_wait_s", "spans",
        "recovered_pipelines", "approximate_rows", "attempt_intervals",
        "replay_max_err", "windows", "parity_drift", "replayed", "whatif",
        "controller_actions"}
    assert got["parity_drift"] == 0.0 and got["replay_max_err"] == 0.0
    assert got["recovered_pipelines"] == got["pipelines"] > 0
    assert got["windows"] == 4 and got["attempt_intervals"] > 0
    assert (tmp_path / "replay_spans.jsonl").stat().st_size > 0


def test_train_lm_restarts_once_and_learns(tmp_path):
    got = load("train_lm").main(device="cpu", steps=12, batch=2, seq=32,
                                ckpt_every=4, log_every=1,
                                ckpt_dir=str(tmp_path))
    assert got["restarts"] == 1 and got["improved"]
    assert got["last_loss"] < got["first_loss"]
    assert np.isfinite([got["first_loss"], got["last_loss"]]).all()
