"""The port's active-set compaction driver
(``repro_torch.core.compaction``) and its ``"torch-compact"`` engine,
against the uncompacted port and the JAX package, on the CPU.

On integer-time workloads made with numpy from a seed, the compacted run
must equal, **bit for bit** on every output key: the port's one
``simulate_ensemble`` call, and the reference's
``simulate_ensemble_compacted`` (its ``"dense"`` admission, which decides
as the port's). The driver's ``CompactionLog`` — segments, gathers, the
working shapes and the live rows per boundary — must equal the
reference's: the host-side window choice is a line-for-line twin. Static
FIFO / PRIORITY / SJF, mixed policies, a starved resource (the loop halts
over queued rows) and small budgets that force many boundaries.

At the engine level, a full-stack sweep (controller, failures with
retries, a fleet with its trigger, a probe) on ``"torch-compact"`` equals
``"torch"`` on every record, timeline and summary key but the wall-derived
ones. The reference's JAX fleet path fails on this tree (its compiled
barrier does not batch), so with a fleet the port is held against the
reference's numpy engine ``des.simulate`` only, through its ``"numpy"``
sweep. Reliability timelines are refused, as the reference refuses them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batching as ref_batching
from repro.core import compaction as ref_compaction
from repro.core import des
from repro.core import experiment as ref_exp
from repro.core import runtime as ref_rt
from repro.obs.probes import ProbeSpec as RefProbe
from repro.ops import capacity as ref_cap
from repro.ops import failures as ref_fail
from repro.ops import scenario as ref_scen
from repro_torch.core import compaction, experiment, runtime, vdes
from repro_torch.core import model as M
from repro_torch.obs.probes import ProbeSpec
from repro_torch.ops import capacity, failures, scenario
from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                     RepairSpec, TopologySpec)
from test_compaction import TRIG, fleet_tensor
from test_des_engines import make_workload, platform
import torch_stage_cases as C

POS = ("arrival", "n_tasks", "task_res", "service", "priority")
#: tiny budgets and windows: many boundaries and width changes
SMALL = dict(segment_waves=17, drain_waves=9, min_rows=4, lookahead=5)
WALL_DERIVED = {"wall_s", "pipelines_per_s", "n_compactions",
                "compaction_segments"}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ensemble(seed=20260807, R=3, n=50, caps=(3, 2)):
    """The reference test's ensemble: R integer-time workloads, padded."""
    rng = np.random.default_rng(seed)
    plat = platform(*caps)
    wls = [make_workload(rng, n - 3 * i, nres=2, integer_time=True,
                         horizon=400.0) for i in range(R)]
    cols = ref_batching.pad_workloads(wls, plat)
    cols.pop("n_max")
    return cols, np.tile(np.asarray(plat.capacities, np.int32)[None], (R, 1))


def assert_same_log(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.distinct_shapes == want.distinct_shapes


def assert_same_out(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].numpy(), want[k].numpy() if torch.is_tensor(want[k])
            else np.asarray(want[k]), err_msg=k)


def twins(cols, caps, knobs=SMALL, **kw):
    """The port's one call, its compacted driver and the reference's
    compacted driver on the same inputs; returns the three results and
    both logs."""
    kw.update({k: v for k, v in cols.items() if k not in POS})
    pos = [cols[k] for k in POS]
    whole = vdes.simulate_ensemble(*pos, caps, device="cpu", **kw)
    log = compaction.CompactionLog()
    got = compaction.simulate_ensemble_compacted(
        *pos, caps, device="cpu", log=log, **knobs, **kw)
    ref_log = ref_compaction.CompactionLog()
    ref = ref_compaction.simulate_ensemble_compacted(
        *pos, caps, admission_sort="dense", log=ref_log, **knobs, **kw)
    return whole, got, ref, log, ref_log


@pytest.mark.parametrize("policy", [des.POLICY_FIFO, des.POLICY_PRIORITY,
                                    des.POLICY_SJF])
def test_compacted_equals_uncompacted_and_reference(policy):
    cols, caps = ensemble()
    whole, got, ref, log, ref_log = twins(cols, caps, policy=policy)
    assert_same_out(got, whole)
    assert_same_out(got, ref)
    assert_same_log(log, ref_log)
    assert log.n_compactions > 5 and log.distinct_shapes > 2


def test_compacted_mixed_policies():
    cols, caps = ensemble(seed=7)
    pol = np.asarray([des.POLICY_FIFO, des.POLICY_SJF, des.POLICY_PRIORITY],
                     np.int32)
    whole, got, ref, log, ref_log = twins(
        cols, caps, knobs=dict(segment_waves=23, drain_waves=23, min_rows=4,
                               lookahead=7), policies=pol)
    assert_same_out(got, whole)
    assert_same_out(got, ref)
    assert_same_log(log, ref_log)


def test_compacted_starved_capacity():
    """A zero-capacity resource leaves QUEUED rows forever: the engine
    halts over them and the driver stops with the same final state instead
    of spinning on the dead replicas."""
    cols, caps = ensemble(caps=(3, 2))
    caps = caps.copy()
    caps[:, 1] = 0
    whole, got, ref, log, ref_log = twins(
        cols, caps, knobs=dict(segment_waves=16, drain_waves=16, min_rows=4,
                               lookahead=4))
    assert_same_out(got, whole)
    assert_same_out(got, ref)
    assert_same_log(log, ref_log)
    assert not bool(got["done"].all())


def test_compacted_with_scenario_and_default_knobs():
    """Retries with backoff, resampled attempts and per-attempt records,
    at the compaction driver's default knobs (the engine's): the carry's
    attempt buffers ride the gathers and scatters."""
    rng = np.random.default_rng(11)
    plat = platform(2, 1)
    wls = [make_workload(rng, 60, nres=2, integer_time=True, horizon=400.0)
           for _ in range(2)]
    sc = ref_scen.Scenario(failures=ref_fail.FailureModel(
        p_fail_by_type=(0.3,) * 6, resample_service=True,
        retry=ref_fail.RetryPolicy(max_retries=2, base_s=4.0, mult=2.0,
                                   cap_s=16.0)))
    comps = [sc.compile(w, plat, 400.0, seed=i) for i, w in enumerate(wls)]
    cols = ref_batching.pad_workloads(wls, plat)
    cols.update(ref_batching.stack_scenarios(
        comps, cols["n_max"], 400.0,
        services=[np.ceil(w.service_time(plat.datastore)) for w in wls]))
    cols.pop("n_max")
    cols["attempt_service"] = np.ceil(cols["attempt_service"])
    caps = np.tile(np.asarray(plat.capacities, np.int32)[None], (2, 1))
    knobs = dict(segment_waves=256, drain_waves=256, min_rows=8,
                 lookahead=24)
    whole, got, ref, log, ref_log = twins(cols, caps, knobs=knobs)
    assert "att_start" in got
    assert_same_out(got, whole)
    assert_same_out(got, ref)
    assert_same_log(log, ref_log)


def _sweep_base(mod_exp, mod_rt, mod_fail, mod_cap, mod_scen, probe, wl,
                plat):
    sc = mod_scen.Scenario(
        name="fs", controller=mod_cap.ReactiveController(
            high_watermark=0.3, step=0.5, max_scale=4.0, interval_s=10.0),
        failures=mod_fail.FailureModel(
            p_fail_by_type=(0.3,) * 6,
            retry=mod_fail.RetryPolicy(max_retries=2, base_s=4.0, mult=2.0,
                                       cap_s=16.0)))
    trig = mod_rt.TriggerSpec(**{f.name: getattr(TRIG, f.name)
                                 for f in dataclasses.fields(TRIG)})
    return mod_exp.ExperimentSpec(
        name="twin", platform=plat, horizon_s=300.0, workload=wl,
        scenario=sc, probe=probe(interval_s=40.0),
        fleet=mod_rt.FleetSpec(params=fleet_tensor()), trigger=trig)


def test_compact_engine_equals_torch_engine_on_full_stack_sweep():
    """``"torch-compact"`` against ``"torch"`` on a capacity x policy grid
    with every stage but reliability: every record, probe timeline and
    summary key equal (the compaction's own counters and the wall aside);
    and each point equal to the reference's numpy engine."""
    rwl = make_workload(np.random.default_rng(20260807), 50,
                        integer_time=True, horizon=300.0)
    pwl = M.Workload(**{f.name: getattr(rwl, f.name)
                        for f in dataclasses.fields(rwl)})
    rplat = platform()
    pplat = M.PlatformConfig(resources=tuple(
        M.ResourceConfig(r.name, r.capacity, r.cost_per_node_hour)
        for r in rplat.resources))
    base = _sweep_base(experiment, runtime, failures, capacity, scenario,
                       ProbeSpec, pwl, pplat)
    axes = {"capacity:a": [3, 4], "policy": [des.POLICY_FIFO,
                                             des.POLICY_SJF]}
    a = experiment.Sweep(base, axes).run(device="cpu")
    b = experiment.Sweep(base.with_(engine="torch-compact"), axes).run(
        device="cpu")
    want = ref_exp.Sweep(_sweep_base(ref_exp, ref_rt, ref_fail, ref_cap,
                                     ref_scen, RefProbe, rwl, rplat),
                         axes).run()
    assert len(a) == len(b) == len(want) == 4
    for x, y, w in zip(a, b, want):
        for f in ("start", "finish", "ready", "attempts", "att_start"):
            np.testing.assert_array_equal(getattr(x.records, f),
                                          getattr(y.records, f), err_msg=f)
            np.testing.assert_array_equal(getattr(y.records, f),
                                          getattr(w.records, f), err_msg=f)
        np.testing.assert_array_equal(x.timeline.values, y.timeline.values)
        np.testing.assert_array_equal(y.timeline.values, w.timeline.values)
        sx, sy, sw = ({k: v for k, v in r.summary.items()
                       if k not in WALL_DERIVED} for r in (x, y, w))
        assert C.same_tree(sx, sy) and C.same_tree(sy, sw)
        assert y.summary["compaction_segments"] \
            == y.summary["n_compactions"] + 1 >= 2
        assert sy["lifecycle"]["n_retrained"] > 0


def test_compaction_refuses_reliability():
    cols, caps = ensemble(R=1)
    with pytest.raises(NotImplementedError, match="reliability"):
        compaction.simulate_ensemble_compacted(
            *(cols[k] for k in POS), caps, device="cpu",
            rel_times=np.full((1, 1), np.inf, np.float32),
            rel_deltas=np.zeros((1, 1, 2), np.int32), n_rel_slots=1)
    wl = M.Workload(**{f.name: getattr(w, f.name) for w in [make_workload(
        np.random.default_rng(0), 10, integer_time=True, horizon=200.0)]
        for f in dataclasses.fields(w)})
    H = 3000.0
    spec = experiment.ExperimentSpec(
        name="r", horizon_s=H, workload=wl, engine="torch-compact",
        reliability=ReliabilitySpec(
            topology=TopologySpec(zones=2, racks_per_zone=2),
            outages=DomainOutageModel(zone_mtbf_s=H / 2, rack_mtbf_s=H / 4,
                                      mttr_s=H / 24),
            repair=RepairSpec(crews=1), time_quantum_s=1.0))
    assert experiment.run_experiment(spec.with_(engine="torch"),
                                     device="cpu").summary[
        "availability"]["n_events"] > 0
    with pytest.raises(NotImplementedError, match="reliability"):
        experiment.run_experiment(spec, device="cpu")


def test_compact_engine_knobs_reach_the_driver(monkeypatch):
    """The engine passes its knobs, the kernel admission by default, and
    logs the compaction driver's work into its summary."""
    from repro_torch.core import engines
    seen = {}
    real = compaction.simulate_ensemble_compacted

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(compaction, "simulate_ensemble_compacted", spy)
    eng = engines.TorchCompactEngine(segment_waves=31, drain_waves=7,
                                     min_rows=16, lookahead=3,
                                     device="cpu")
    wl = M.Workload(**{f.name: getattr(w, f.name) for w in [make_workload(
        np.random.default_rng(2), 30, integer_time=True, horizon=200.0)]
        for f in dataclasses.fields(w)})
    res = eng.run(experiment.ExperimentSpec(name="k", horizon_s=300.0,
                                            workload=wl,
                                            engine="torch-compact"))
    assert {k: seen[k] for k in ("segment_waves", "drain_waves", "min_rows",
                                 "lookahead", "admission_sort")} == dict(
        segment_waves=31, drain_waves=7, min_rows=16, lookahead=3,
        admission_sort="kernel")
    assert res.summary["compaction_segments"] == eng.last_log.n_segments
    assert engines.get_engine("torch-compact").name == "torch-compact"
