"""The port's reliability stage (``reliability/specs.py``,
``reliability/compile.py``, the control stage's reliability events,
``accounting.availability_summary``) against the JAX package, on the CPU.

Tolerance: **bit for bit** throughout. Every reliability draw is numpy's
(``SeedSequence([seed, 0xE7])``) and the repair queue is the f64
``single_station_fifo`` on the host in both packages, so the compiled
timelines are equal field for field. On whole-second workloads
(``time_quantum_s = 1``) the port's ``simulate_ensemble`` equals the JAX
engine on every output key (``rel_act``/``rel_n`` and the wave counts
included) and each replica equals ``des.simulate`` (``rel_times``/
``rel_caps``); a ``"reliability:repair"`` Sweep is one
``simulate_ensemble`` call, equal point by point to separate runs and to
the reference's numpy engine, availability blocks included.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_stage_cases as C
from repro import reliability as RR
from repro.checkpoint.manager import StragglerMonitor as RefStraggler
from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.core import model as RM
from repro.ops import accounting as ref_acc
from repro.ops import scenario as ref_scen
from repro.ops.failures import FailureModel as RefFailureModel
from repro_torch import reliability as PR
from repro_torch.checkpoint.manager import StragglerMonitor
from repro_torch.core import batching, experiment, vdes
from repro_torch.core import model as M
from repro_torch.core.workload import generate_empirical_workload, whole_seconds
from repro_torch.ops import accounting, scenario
from repro_torch.ops.failures import FailureModel


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(mod, kind, H):
    """A reliability spec of ``mod`` (the reference's or the port's)."""
    out = mod.DomainOutageModel(zone_mtbf_s=H / 2.0, rack_mtbf_s=H / 4.0,
                                mttr_s=H / 24.0)
    topo = mod.TopologySpec(zones=2, racks_per_zone=2)
    if kind == "crews":
        return mod.ReliabilitySpec(topology=topo, outages=out,
                                   repair=mod.RepairSpec(crews=1),
                                   time_quantum_s=1.0)
    if kind == "spot":
        return mod.ReliabilitySpec(
            topology=mod.TopologySpec(zones=2, racks_per_zone=4), outages=out,
            repair=mod.RepairSpec(crews=2, repair_time_s=H / 12.0),
            spot=mod.SpotPoolSpec(frac=0.25, evict_mtbe_s=H / 3.0,
                                  reclaim_s=H / 48.0),
            checkpoint=mod.CheckpointSpec(ckpt_frac=0.4),
            time_quantum_s=1.0)
    if kind == "raw":      # no quantum: exponential times as drawn
        return mod.ReliabilitySpec(topology=topo, outages=dataclasses.replace(
            out, resources=(1,)), repair=None)
    return mod.ReliabilitySpec(topology=topo, outages=None, repair=None,
                               spot=mod.SpotPoolSpec(frac=0.5,
                                                     evict_mtbe_s=H / 4.0))


@pytest.mark.parametrize("kind", ["crews", "spot", "raw", "spot_only"])
@pytest.mark.parametrize("seed", [0, 5])
def test_compile_reliability_equals_reference(kind, seed):
    """Every field of the compiled timeline — times, deltas, the event
    records, spot slices, eviction attempts, repair waits, queue depth and
    stragglers — equals the reference's."""
    H = 0.5 * 86400.0
    wl = generate_empirical_workload(seed, H)
    want = RR.compile_reliability(_spec(RR, kind, H), wl, RM.PlatformConfig(),
                                  H, seed=seed)
    got = PR.compile_reliability(_spec(PR, kind, H), wl, M.PlatformConfig(),
                                 H, seed=seed)
    assert _spec(PR, kind, H).name == _spec(RR, kind, H).name
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "events":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                for g in dataclasses.fields(x):
                    C.assert_same(getattr(y, g.name), getattr(x, g.name),
                                  g.name)
        elif a is None:
            assert b is None, f.name
        else:
            C.assert_same(b, a, f.name)
    assert want.n_events == got.n_events > 0
    C.assert_same(got.cum_deltas(), want.cum_deltas(), "cum")


def test_double_apply_is_rejected_as_in_reference():
    rel = PR.ReliabilitySpec(checkpoint=PR.CheckpointSpec())
    with pytest.raises(ValueError, match="double-apply"):
        PR.check_no_double_apply(rel, scenario.Scenario(
            failures=FailureModel(fail_holds_frac=0.5)))
    PR.check_no_double_apply(rel, scenario.Scenario(failures=FailureModel()))
    PR.check_no_double_apply(None, None)


def test_straggler_monitor_flags_as_reference():
    rng = np.random.default_rng(0)
    times = rng.exponential(1.0, 200)
    a, b = RefStraggler(window=10), StragglerMonitor(window=10)
    assert [a.record(i, t) for i, t in enumerate(times)] == \
        [b.record(i, t) for i, t in enumerate(times)]
    assert a.flagged == b.flagged and a.flagged


@pytest.fixture(scope="module")
def case():
    """Reliability-only ensemble (replica 3 without: the INF padding
    rows) through both host sides, the port's engine and the JAX engine."""
    rp, pp = C.platforms()
    wls = C.workloads(13, sizes=(C.N, C.N - 4, C.N, C.N - 7))
    pwls = [C.port_workload(w) for w in wls]
    kinds = ("crews", "spot", "raw", None)
    H = C.HORIZON
    rrels = [RR.compile_reliability(_spec(RR, k, H), w, rp, H, seed=i)
             if k else None for i, (k, w) in enumerate(zip(kinds, wls))]
    prels = [PR.compile_reliability(_spec(PR, k, H), w, pp, H, seed=i)
             if k else None for i, (k, w) in enumerate(zip(kinds, pwls))]
    # whole-second event times for the engines (the "raw" spec's are not)
    rrels[2] = dataclasses.replace(rrels[2], times=np.ceil(rrels[2].times))
    prels[2] = dataclasses.replace(prels[2], times=np.ceil(prels[2].times))
    rc, pc = C.stacked(None, None, wls, pwls, (rp, pp))
    from repro.core import batching as ref_batching
    rc.update(ref_batching.stack_reliability(rrels))
    pc.update(batching.stack_reliability(prels))
    caps = np.array([C.CAPS] * C.R, np.int32)
    return dict(wls=wls, pwls=pwls, rrels=rrels, prels=prels, rc=rc, pc=pc,
                caps=caps, plats=(rp, pp), port=C.run_port(pc, caps),
                ref=C.run_jax(rc, caps))


def test_reliability_ensemble_equals_jax_engine(case):
    """Every output key, the fired-event buffer included, equals the JAX
    engine's; events fired on replicas 0-2 and none on the padded one."""
    C.assert_same_cols(case["rc"], case["pc"])
    C.assert_same_outputs(case["port"], case["ref"])
    n = case["port"]["rel_n"]
    assert (n[:3] > 0).all() and n[3] == 0, n


def test_reliability_replicas_equal_numpy_engine(case):
    """Each replica's task times and event timeline (and, where no padding
    row runs, its wave count) equal ``des.simulate``'s."""
    rp = case["plats"][0]
    out = {k: torch.from_numpy(v) for k, v in case["port"].items()}
    for i, wl in enumerate(case["wls"]):
        tr = ref_des.simulate(wl, rp, 0, reliability=case["rrels"][i])
        got = batching.batch_trace(out, i, case["pwls"][i], rp.capacities,
                                   with_scenario=False,
                                   reliability=case["prels"][i])
        for k in ("start", "finish", "ready", "rel_times", "rel_caps"):
            a, b = getattr(got, k), getattr(tr, k)
            assert (a is None) == (b is None), k
            if b is not None:
                C.assert_same(a, b, f"{i} {k}")
        if wl.n == case["rc"]["n_max"]:
            assert got.waves == tr.waves, i


def test_simulate_to_trace_with_reliability_matches_numpy_engine(case):
    rp, pp = case["plats"]
    tr = ref_des.simulate(case["wls"][0], rp, 0,
                          reliability=case["rrels"][0])
    got = vdes.simulate_to_trace(case["pwls"][0], pp, 0,
                                 reliability=case["prels"][0], device="cpu")
    for k in ("start", "finish", "ready", "rel_times", "rel_caps"):
        C.assert_same(getattr(got, k), getattr(tr, k), k)
    assert got.waves == tr.waves


def test_availability_summary_equals_reference(case):
    """On equal traces the availability block and the realized schedule
    (outage dips and repair-delayed returns) equal the reference's."""
    rp, pp = case["plats"]
    for i in range(3):
        tr = ref_des.simulate(case["wls"][i], rp, 0,
                              reliability=case["rrels"][i])
        assert accounting.availability_summary(
            case["prels"][i], pp, tr=tr) == ref_acc.availability_summary(
            case["rrels"][i], rp, tr=tr)
        comp = ref_scen.compile_static(case["wls"][i], rp)
        a = ref_acc.realized_schedule(tr, comp)
        b = accounting.realized_schedule(tr, scenario.compile_static(
            case["pwls"][i], pp))
        C.assert_same(b.times, a.times, "times")
        C.assert_same(b.caps, a.caps, "caps")


def _sweep_base(mod_exp, mod_rel, mod_fail, mod_scen, wl, plat, H):
    return mod_exp.ExperimentSpec(
        name="rel", platform=plat, horizon_s=H, seed=2, n_replicas=2,
        workload=wl,
        reliability=mod_rel.ReliabilitySpec(
            topology=mod_rel.TopologySpec(zones=2, racks_per_zone=2),
            outages=mod_rel.DomainOutageModel(zone_mtbf_s=H / 2.0,
                                              rack_mtbf_s=H / 4.0,
                                              mttr_s=H / 24.0),
            spot=mod_rel.SpotPoolSpec(frac=0.25, evict_mtbe_s=H / 3.0,
                                      reclaim_s=H / 48.0),
            time_quantum_s=1.0),
        scenario=mod_scen.Scenario(failures=mod_fail(
            p_fail_by_type=(0.1,) * 6)))


def test_reliability_sweep_is_one_call_and_equals_numpy_engine(monkeypatch):
    """A ``"reliability:repair"`` Sweep (1, 2 and 6 crews, 2 replicas each,
    spot evictions folded into the attempts) runs as ONE
    ``simulate_ensemble`` call; each point equals its own run and the
    reference's numpy engine summary, availability blocks included."""
    H = 0.05 * 86400.0
    plat = M.PlatformConfig().with_capacity("learning_cluster", 8)
    rplat = RM.PlatformConfig().with_capacity("learning_cluster", 8)
    pwl = whole_seconds(generate_empirical_workload(21, H), plat.datastore)
    rwl = RM.Workload(**{f.name: getattr(pwl, f.name)
                         for f in dataclasses.fields(pwl)})
    crews = [1, 2, 6]
    calls = []
    real = vdes.simulate_ensemble
    monkeypatch.setattr(vdes, "simulate_ensemble",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = _sweep_base(experiment, PR, FailureModel, scenario, pwl, plat, H)
    got = experiment.Sweep(base, {"reliability:repair": [
        PR.RepairSpec(crews=c) for c in crews]}).run(device="cpu")
    assert len(calls) == 1
    rbase = _sweep_base(ref_exp, RR, RefFailureModel, ref_scen, rwl, rplat, H)
    want = ref_exp.Sweep(rbase, {"reliability:repair": [
        RR.RepairSpec(crews=c) for c in crews]}).run()
    for c, g, w in zip(crews, got, want):
        one = experiment.run_experiment(
            base.with_(**{"reliability:repair": PR.RepairSpec(crews=c)}),
            device="cpu")
        assert g.experiment.name == w.experiment.name
        for a, b, d in zip(g.replica_summaries, w.replica_summaries,
                           one.replica_summaries):
            a, b, d = (C.without_wall(x) for x in (a, b, d))
            assert C.same_tree(a, b) and C.same_tree(a, d)
            assert a["availability"]["n_events"] > 0
            assert a["availability"]["eviction"]["evicted_tasks"] > 0


@pytest.mark.parametrize("with_scenario", [False, True])
def test_fold_reliability_equals_reference(with_scenario):
    """Spot-eviction retries and checkpointed retry durations fold into
    the compiled scenario as the reference folds them: attempts and the
    f32-scaled ``attempt_service`` equal, with and without a scenario
    that already resamples its retries."""
    from repro.core import engines as ref_engines
    from repro_torch.core import engines
    H = 0.25 * 86400.0
    wl = generate_empirical_workload(8, H)
    rp, pp = RM.PlatformConfig(), M.PlatformConfig()
    want_rel = RR.compile_reliability(_spec(RR, "spot", H), wl, rp, H, seed=3)
    got_rel = PR.compile_reliability(_spec(PR, "spot", H), wl, pp, H, seed=3)
    rc = pc = None
    if with_scenario:
        rc = ref_scen.Scenario(failures=RefFailureModel(
            resample_service=True)).compile(wl, rp, H, seed=3)
        pc = scenario.Scenario(failures=FailureModel(
            resample_service=True)).compile(wl, pp, H, seed=3)
    want = ref_engines._fold_reliability(rc, want_rel, wl, rp)
    got = engines._fold_reliability(pc, got_rel, wl, pp)
    C.assert_same(got.attempts, want.attempts, "attempts")
    C.assert_same(got.attempt_service, want.attempt_service, "service")
    assert got.attempts.max() > 1
