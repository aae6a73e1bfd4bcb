"""The port's closed-loop controller (the control stage's controller,
``ops.capacity.ReactiveController``/``ReactiveAutoscaler`` and the
realized-schedule accounting) against the JAX package, on the CPU.

Tolerance: **bit for bit** throughout. On whole-second workloads the
port's ``simulate_ensemble`` equals the JAX ``vdes.simulate_ensemble`` on
every output key (the realized-action buffer ``ctrl_act``/``ctrl_n`` and the
wave counts included) and each replica equals the numpy engine
``des.simulate`` (``ctrl_times``/``ctrl_caps`` included). The compiled
ControllerParams rows, the autoscaler's planned schedule, the realized
schedule and the summaries' planned/realized blocks equal the reference's.
"""
import numpy as np
import pytest
import torch

import torch_stage_cases as C
from repro.core import des as ref_des
from repro.core import experiment as ref_exp
from repro.ops import accounting as ref_acc
from repro.ops import capacity as ref_cap
from repro.ops import scenario as ref_scen
from repro.ops.failures import FailureModel as RefFailureModel
from repro_torch.core import batching, des, experiment, vdes
from repro_torch.ops import accounting, capacity, scenario
from repro_torch.ops.failures import FailureModel

# per replica: (controller kwargs or None, maintenance window or None,
# failures) — replica 3 carries the all-zero padding row
CASES = [
    (dict(high_watermark=0.3, step=0.5, max_scale=3.0, interval_s=60.0),
     None, False),
    (dict(high_watermark=0.5, low_watermark=0.2, step=0.25,
          interval_s=45.0, cooldown_s=120.0), (100.0, 300.0, 0, 0.5), True),
    (dict(high_watermark=0.2, step=0.5, min_scale=0.25, interval_s=50.0,
          resources=(1,)), None, True),
    (None, (50.0, 250.0, 1, 0.0), False),
]
POLICIES = np.array([0, 1, 2, 0], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenarios(cap_mod, fail_mod, scen_mod):
    out = []
    for ctrl, window, flaky in CASES:
        out.append(scen_mod.Scenario(
            capacity=cap_mod.MaintenanceWindows((window,)) if window else None,
            failures=fail_mod(p_fail_by_type=(0.3,) * 6) if flaky else None,
            controller=cap_mod.ReactiveController(**ctrl) if ctrl else None))
    return out


@pytest.fixture(scope="module")
def case():
    """The controller ensemble through both host sides, the port's engine
    and the JAX engine."""
    rp, pp = C.platforms()
    wls = C.workloads(7, sizes=(C.N, C.N - 5, C.N, C.N - 9))
    pwls = [C.port_workload(w) for w in wls]
    rcomps = [s.compile(w, rp, C.HORIZON, seed=i, policy=int(POLICIES[i]))
              for i, (s, w) in enumerate(zip(
                  _scenarios(ref_cap, RefFailureModel, ref_scen), wls))]
    pcomps = [s.compile(w, pp, C.HORIZON, seed=i, policy=int(POLICIES[i]),
                        device="cpu")
              for i, (s, w) in enumerate(zip(
                  _scenarios(capacity, FailureModel, scenario), pwls))]
    rc, pc = C.stacked(rcomps, pcomps, wls, pwls, (rp, pp))
    caps = np.array([C.CAPS] * C.R, np.int32)
    return dict(wls=wls, pwls=pwls, rcomps=rcomps, pcomps=pcomps, rc=rc,
                pc=pc, caps=caps, plats=(rp, pp),
                port=C.run_port(pc, caps, POLICIES),
                ref=C.run_jax(rc, caps, POLICIES))


def test_controller_rows_equal_reference(case):
    """The compiled ``[C]`` rows, the disabled row, the tick bound and the
    batched unpacking equal the reference's; the stacked columns equal."""
    for rc_, pc_ in zip(case["rcomps"], case["pcomps"]):
        if rc_.controller is None:
            assert pc_.controller is None
            continue
        C.assert_same(rc_.controller, pc_.controller, "controller")
        assert des.ctrl_tick_bound(pc_.controller) == \
            ref_des.ctrl_tick_bound(rc_.controller)
    C.assert_same(ref_cap.disabled_controller(3),
                  capacity.disabled_controller(3), "disabled")
    C.assert_same_cols(case["rc"], case["pc"])
    rows = case["pc"]["controllers"]
    for got, row in zip(zip(*des.unpack_controller(rows)), rows):
        for g, w in zip(got, ref_des.unpack_controller(row)):
            C.assert_same(g, w, "unpack")


def test_controller_ensemble_equals_jax_engine(case):
    """Every output key, the realized-action buffer included, equals the
    JAX engine's; the controllers moved capacity on replicas 0-2 and the
    padding row never did."""
    C.assert_same_outputs(case["port"], case["ref"])
    n = case["port"]["ctrl_n"]
    assert (n[:3] > 0).all() and n[3] == 0, n


def test_controller_replicas_equal_numpy_engine(case):
    """Each replica's task times, attempts, realized timeline and (where
    no padding row runs) wave count equal ``des.simulate``'s."""
    rp = case["plats"][0]
    out = case["port"]
    K = case["rc"]["cap_times"].shape[1]
    full = 0
    for i, (wl, comp) in enumerate(zip(case["wls"], case["rcomps"])):
        tr = C.numpy_trace(wl, rp, int(POLICIES[i]), comp, K)
        got = batching.batch_trace({k: torch.from_numpy(v)
                                    for k, v in out.items()}, i,
                                   case["pwls"][i], rp.capacities)
        for k in ("start", "finish", "ready", "attempts", "completed"):
            C.assert_same(getattr(got, k), getattr(tr, k), f"{i} {k}")
        if comp.controller is not None:
            C.assert_same(got.ctrl_times, tr.ctrl_times, f"{i} ctrl_times")
            C.assert_same(got.ctrl_caps, tr.ctrl_caps, f"{i} ctrl_caps")
        if wl.n == case["rc"]["n_max"]:
            assert got.waves == tr.waves, i
            full += 1
    assert full == 2


def test_simulate_to_trace_matches_numpy_engine(case):
    """The single-replica path with a controller (and a schedule and
    failures) equals ``des.simulate`` exactly, realized timeline and waves
    included."""
    rp, pp = case["plats"]
    wl, rcomp, pcomp = case["wls"][1], case["rcomps"][1], case["pcomps"][1]
    tr = ref_des.simulate(wl, rp, 1, scenario=rcomp)
    got = vdes.simulate_to_trace(case["pwls"][1], pp, 1, scenario=pcomp,
                                 device="cpu")
    for k in ("start", "finish", "ready", "attempts", "completed",
              "att_start", "att_finish", "ctrl_times", "ctrl_caps"):
        C.assert_same(getattr(got, k), getattr(tr, k), k)
    assert got.waves == tr.waves


def test_realized_schedule_and_summary_equal_reference(case):
    """On equal traces the realized schedule and the summary's realized
    and planned blocks equal the reference's."""
    rp, pp = case["plats"]
    from repro.core import trace as ref_trace
    from repro_torch.core import trace
    for i in range(3):
        tr = ref_des.simulate(case["wls"][i], rp, int(POLICIES[i]),
                              scenario=case["rcomps"][i])
        a = ref_acc.realized_schedule(tr, case["rcomps"][i])
        b = accounting.realized_schedule(tr, case["pcomps"][i])
        C.assert_same(a.times, b.times, "times")
        C.assert_same(a.caps, b.caps, "caps")
        kw = dict(schedule=case["rcomps"][i].schedule,
                  cost_rates=rp.cost_rates)
        want = ref_trace.summarize(ref_trace.flatten_trace(tr, case["wls"][i]),
                                   rp.capacities, C.HORIZON, realized=a, **kw)
        got = trace.summarize(trace.flatten_trace(tr, case["pwls"][i]),
                              pp.capacities, C.HORIZON, realized=b, **kw)
        assert C.same_tree(got, want)
        assert "realized_vs_planned_cost_delta" in got


def test_reactive_autoscaler_plans_the_reference_schedule():
    """The open-loop autoscaler plans from the port's own engine on the CPU;
    on a whole-second workload its schedule equals the reference's, which
    plans with the numpy engine (two fixed-point iterations)."""
    rp, pp = C.platforms()
    wl = C.workloads(3, sizes=(120,), horizon=1800.0)[0]
    kw = dict(high_watermark=0.3, low_watermark=0.1, interval_s=300.0,
              n_iters=2)
    want = ref_cap.ReactiveAutoscaler(**kw).build(
        rp.capacities, 1800.0, workload=wl, platform=rp)
    got = capacity.ReactiveAutoscaler(**kw).build(
        pp.capacities, 1800.0, workload=C.port_workload(wl), platform=pp,
        device="cpu")
    C.assert_same(got.times, want.times, "times")
    C.assert_same(got.caps, want.caps, "caps")
    assert got.n_changes > 1


def test_controller_axis_composes_as_the_reference():
    """``with_(controller=...)`` sets the controller on the scenario after
    every other key, keeps a scenario-less spec pristine for None, and the
    names distinguish gains."""
    c = capacity.ReactiveController(step=0.5)
    s = experiment.ExperimentSpec(name="x")
    assert s.with_(controller=None).scenario is None
    a = s.with_(controller=c, scenario=scenario.Scenario(name="s"))
    assert a.scenario.name == "s" and a.scenario.controller == c
    assert c.name == ref_cap.ReactiveController(step=0.5).name
    assert capacity.ReactiveController(cooldown_s=5).name != \
        capacity.ReactiveController().name


def test_controller_experiment_equals_numpy_engine():
    """``run_experiment`` with a controller (4 replicas) equals the
    reference's numpy engine summary, planned/realized cost included."""
    rp, pp = C.platforms()
    wl = C.workloads(11, sizes=(C.N,))[0]
    ctrl = dict(high_watermark=0.3, step=0.5, max_scale=3.0, interval_s=60.0)
    want = ref_exp.run_experiment(ref_exp.ExperimentSpec(
        name="c", platform=rp, horizon_s=C.HORIZON, engine="numpy",
        workload=wl, n_replicas=4,
        scenario=ref_scen.Scenario(
            failures=RefFailureModel(p_fail_by_type=(0.2,) * 6),
            controller=ref_cap.ReactiveController(**ctrl))))
    got = experiment.run_experiment(experiment.ExperimentSpec(
        name="c", platform=pp, horizon_s=C.HORIZON,
        workload=C.port_workload(wl), n_replicas=4,
        scenario=scenario.Scenario(
            failures=FailureModel(p_fail_by_type=(0.2,) * 6),
            controller=capacity.ReactiveController(**ctrl))), device="cpu")
    assert C.same_tree(C.without_wall(got.summary),
                       C.without_wall(want.summary))
    assert "planned_total_cost" in got.summary
    for g, w in zip(got.replica_summaries, want.replica_summaries):
        assert C.same_tree(C.without_wall(g), C.without_wall(w))
