"""The port's probe stage (``obs/probes.py`` and the wave loop's sixth
stage) against the JAX package, on the CPU.

Tolerance: **bit for bit**. The compiled probe headers and tick grids and
the channel names equal the reference's. On whole-second workloads with a
controller and reliability events moving capacity, the port's
``simulate_ensemble`` equals the JAX engine on every output key
(``probe_vals``/``probe_n`` and the wave counts included) and each replica's
telemetry equals ``des.simulate``'s; a probe never changes a task time.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_stage_cases as C
from repro import reliability as RR
from repro.core import batching as ref_batching
from repro.core import des as ref_des
from repro.obs import probes as ref_probes
from repro.ops import capacity as ref_cap
from repro.ops import scenario as ref_scen
from repro_torch import reliability as PR
from repro_torch.core import batching, des, vdes
from repro_torch.obs import probes
from repro_torch.ops import capacity, scenario

PROBES = (probes.ProbeSpec(interval_s=50.0),
          probes.ProbeSpec(interval_s=35.0, t_first=10.0),
          probes.ProbeSpec(interval_s=120.0), None)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("interval,t_first,horizon,n_models", [
    (900.0, None, 86400.0, 0), (35.0, 10.0, 600.0, 3),
    (1e-3, None, 30.0, 1), (7.0, 7.0, 7.0, 0)])
def test_compile_probe_equals_reference(interval, t_first, horizon,
                                        n_models):
    want = ref_probes.compile_probe(ref_probes.ProbeSpec(interval, t_first),
                                    horizon, n_models=n_models)
    got = probes.compile_probe(probes.ProbeSpec(interval, t_first), horizon,
                               n_models=n_models)
    C.assert_same(got.header, want.header, "header")
    C.assert_same(got.times, want.times, "times")
    assert got.n_ticks == want.n_ticks == des.fleet_tick_grid(
        interval, t_first or interval, horizon).shape[0]
    names = ["a", "b", "c"]
    assert probes.probe_channel_names(names) == \
        ref_probes.probe_channel_names(names)
    with pytest.raises(ValueError):
        probes.compile_probe(probes.ProbeSpec(interval_s=0.0), horizon)


def _stages(cap_mod, scen_mod, rel_mod, wls, plat):
    ctrl = cap_mod.ReactiveController(high_watermark=0.3, step=0.5,
                                      max_scale=3.0, interval_s=60.0)
    comps = [scen_mod.Scenario(controller=ctrl if i != 1 else None).compile(
        w, plat, C.HORIZON, seed=i) for i, w in enumerate(wls)]
    rel = rel_mod.ReliabilitySpec(
        topology=rel_mod.TopologySpec(zones=2, racks_per_zone=1),
        outages=rel_mod.DomainOutageModel(zone_mtbf_s=200.0,
                                          rack_mtbf_s=100.0, mttr_s=30.0),
        time_quantum_s=1.0)
    rels = [rel_mod.compile_reliability(rel, w, plat, C.HORIZON, seed=i)
            if i != 2 else None for i, w in enumerate(wls)]
    return comps, rels


@pytest.fixture(scope="module")
def case():
    rp, pp = C.platforms()
    wls = C.workloads(17, sizes=(C.N, C.N - 3, C.N, C.N - 6))
    pwls = [C.port_workload(w) for w in wls]
    rcomps, rrels = _stages(ref_cap, ref_scen, RR, wls, rp)
    pcomps, prels = _stages(capacity, scenario, PR, pwls, pp)
    rpr = [ref_probes.compile_probe(ref_probes.ProbeSpec(
        p.interval_s, p.t_first), C.HORIZON) if p else None for p in PROBES]
    ppr = [probes.compile_probe(p, C.HORIZON) if p else None for p in PROBES]
    rc, pc = C.stacked(rcomps, pcomps, wls, pwls, (rp, pp))
    rc.update(ref_batching.stack_reliability(rrels))
    pc.update(batching.stack_reliability(prels))
    rc.update(ref_batching.stack_probes(rpr))
    pc.update(batching.stack_probes(ppr))
    caps = np.array([C.CAPS] * C.R, np.int32)
    return dict(wls=wls, pwls=pwls, rcomps=rcomps, rrels=rrels, rpr=rpr,
                pcomps=pcomps, prels=prels, ppr=ppr, rc=rc, pc=pc,
                caps=caps, plats=(rp, pp), port=C.run_port(pc, caps),
                ref=C.run_jax(rc, caps))


def test_probe_ensemble_equals_jax_engine(case):
    """Every output key, the telemetry buffer included, equals the JAX
    engine's; each probed replica ran its whole tick grid (ticks keep a
    replica alive) and the disabled header row ran none."""
    C.assert_same_cols(case["rc"], case["pc"])
    C.assert_same_outputs(case["port"], case["ref"])
    n = case["port"]["probe_n"]
    assert list(n) == [p.n_ticks if p else 0 for p in case["ppr"]]


def test_probe_replicas_equal_numpy_engine(case):
    """Each replica's telemetry, task times and (where no padding row runs)
    wave count equal ``des.simulate``'s; the fleet channels are NaN
    without a fleet and the capacity channels moved."""
    rp = case["plats"][0]
    out = {k: torch.from_numpy(v) for k, v in case["port"].items()}
    K = case["rc"]["cap_times"].shape[1]
    for i, wl in enumerate(case["wls"]):
        tr = C.numpy_trace(wl, rp, 0, case["rcomps"][i], K,
                           probe=case["rpr"][i], reliability=case["rrels"][i])
        got = batching.batch_trace(out, i, case["pwls"][i], rp.capacities,
                                   probe=case["ppr"][i],
                                   reliability=case["prels"][i])
        for k in ("start", "finish", "ready", "probe_times", "probe_vals",
                  "rel_times", "rel_caps"):
            a, b = getattr(got, k), getattr(tr, k)
            assert (a is None) == (b is None), (i, k)
            if b is not None:
                C.assert_same(a, b, f"{i} {k}")
        if wl.n == case["rc"]["n_max"]:
            assert got.waves == tr.waves, i
        if case["ppr"][i] is not None:
            tl = probes.ProbeTimeline.from_trace(got, case["plats"][1])
            want = ref_probes.ProbeTimeline.from_trace(tr, rp)
            assert tl.channels == want.channels
            C.assert_same(tl.values, want.values, "timeline")
            assert tl.sampled.all()
            assert np.isnan(tl.channel("fleet_min_perf")).all()
            assert set(tl.as_dict()) == set(want.as_dict())


def test_probes_do_not_change_the_physics(case):
    """The same ensemble without probes: every task time and attempt equal
    (the probe ticks add waves of their own, nothing else)."""
    pc = {k: v for k, v in case["pc"].items()
          if k not in ("probes", "n_probe_slots")}
    bare = C.run_port(pc, case["caps"])
    for k in ("start", "finish", "ready", "attempts", "done", "ctrl_act",
              "rel_act"):
        C.assert_same(bare[k], case["port"][k], k)
    assert (bare["waves"] <= case["port"]["waves"]).all()


def test_simulate_to_trace_with_probe_matches_numpy_engine(case):
    rp, pp = case["plats"]
    tr = ref_des.simulate(case["wls"][0], rp, 0, scenario=case["rcomps"][0],
                          probe=case["rpr"][0], reliability=case["rrels"][0])
    got = vdes.simulate_to_trace(case["pwls"][0], pp, 0,
                                 scenario=case["pcomps"][0],
                                 probe=case["ppr"][0],
                                 reliability=case["prels"][0], device="cpu")
    for k in ("start", "finish", "ready", "probe_times", "probe_vals",
              "ctrl_times", "ctrl_caps", "rel_times", "rel_caps"):
        C.assert_same(getattr(got, k), getattr(tr, k), k)
    assert got.waves == tr.waves
    assert [a[0] for a in got.action_timeline()] == \
        [a[0] for a in tr.action_timeline()]
    assert dataclasses.fields(got)[-1].name == "waves"
