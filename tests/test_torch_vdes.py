"""The port's batched engine against the reference engines, on the CPU.

Integer-time workloads (exactly representable in f32 and f64) made with
numpy from a seed go through the reference's host side
(``pad_workloads``/``stack_scenarios``), then into the port through
``to_tensors`` and into the reference's ``vdes.simulate_ensemble``
(``admission_sort="pallas"``, interpret mode, and ``"fused"``), and each
replica through the numpy engine ``des.simulate``. The port must equal
them **exactly**: start/finish/ready, executed attempts, per-attempt
records, completion and the wave count.

The scenario cases share one set of tensor shapes and kwargs so the
reference compiles once per admission mode.
"""
import numpy as np
import pytest
import torch

from repro.core import batching as ref_batching
from repro.core import des
from repro.core import model as RM
from repro.core import vdes as ref_vdes
from repro.core.workload import generate_empirical_workload
from repro.ops.capacity import MaintenanceWindows
from repro.ops.failures import FailureModel
from repro.ops.scenario import CompiledScenario, Scenario
from repro_torch.core import batching, vdes
from test_des_engines import make_workload

R, N, T, HORIZON = 4, 48, 3, 300.0
CAPS = [(3, 2), (2, 1), (4, 2), (1, 1)]
A_SLOTS, K_SLOTS = 4, 4
KEYS = ("start", "finish", "ready", "attempts", "done", "waves")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def platforms():
    return [RM.PlatformConfig(resources=(RM.ResourceConfig("a", a),
                                         RM.ResourceConfig("b", b)))
            for a, b in CAPS]


def capacities():
    return np.array(CAPS, np.int32)


def workloads(sizes=(N,) * R, seed=0):
    """Integer-time workloads (exact in f32 and f64) over two resources."""
    return [make_workload(np.random.default_rng(seed * 100 + i), n,
                          max_tasks=T, integer_time=True, horizon=HORIZON)
            for i, n in enumerate(sizes)]


def run_port(cols, policy=des.POLICY_FIFO, **kw):
    return vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                  capacities=capacities(), policy=policy,
                                  device="cpu", **kw)


def run_ref(cols, sort, policy=des.POLICY_FIFO, **kw):
    cols = {k: v for k, v in cols.items() if k != "n_max"}
    return ref_vdes.simulate_ensemble(**cols, capacities=capacities(),
                                      policy=policy, admission_sort=sort, **kw)


def assert_same(port, ref, keys=KEYS):
    """Equal values, NaN where NaN (a tensor result may be on the card)."""
    for k in keys:
        np.testing.assert_array_equal(port[k].cpu().numpy(),
                                      np.asarray(ref[k].cpu() if
                                                 torch.is_tensor(ref[k])
                                                 else ref[k]), err_msg=k)


def assert_matches_des(port, wls, policies, compiled=None, waves=True):
    """Each replica equals the numpy engine on its live tasks, exactly."""
    for i, (wl, plat) in enumerate(zip(wls, platforms())):
        tr = des.simulate(wl, plat, int(policies[i]),
                          scenario=None if compiled is None else compiled[i])
        n = wl.n
        live = np.arange(T)[None, :] < wl.n_tasks[:, None]
        for k in ("start", "finish", "ready"):
            got = port[k][i, :n].numpy().astype(np.float64)
            np.testing.assert_array_equal(got[live], getattr(tr, k)[live],
                                          err_msg=f"replica {i} {k}")
        if compiled is not None:
            np.testing.assert_array_equal(
                port["attempts"][i, :n].numpy()[live], tr.attempts[live])
            np.testing.assert_array_equal(port["done"][i, :n].numpy(),
                                          tr.completed)
            if tr.att_start is not None:
                A = tr.att_start.shape[2]
                for k in ("att_start", "att_finish"):
                    got = port[k][i, :n].numpy().astype(np.float64)
                    np.testing.assert_array_equal(got[live][:, :A],
                                                  getattr(tr, k)[live])
                    assert np.isnan(got[live][:, A:]).all()
        else:
            assert port["done"][i, :n].numpy().all()
        if waves:
            assert int(port["waves"][i]) == tr.waves, f"replica {i} waves"


# ------------------------------------------------------- static policies

@pytest.mark.parametrize("policy", [des.POLICY_FIFO, des.POLICY_PRIORITY,
                                    des.POLICY_SJF])
def test_static_policy_matches_reference(policy):
    wls = workloads()
    cols = ref_batching.pad_workloads(wls, platforms())
    port = run_port(cols, policy)
    assert_same(port, run_ref(cols, "pallas", policy))
    assert_matches_des(port, wls, [policy] * R)


# ------------------------------------------- scenarios, one shared shape

def _scenario_cols(wls, compiled):
    """Stack through the reference's host side, then fill every optional
    scenario kwarg with its inert value so all scenario cases share one
    signature: attempt_service broadcast from the base service (every
    attempt re-runs at the base duration), fail_holds_frac 1.0, schedules
    padded to K_SLOTS no-op change points, A_SLOTS recording slots.
    Returns the columns and the padded scenarios (the numpy engine's
    input: a padded change point is a wave of its own in every engine)."""
    plats = platforms()
    cols = ref_batching.pad_workloads(wls, plats, n_max=N)
    padded = [CompiledScenario(schedule=c.schedule.padded(K_SLOTS, HORIZON),
                               attempts=c.attempts, backoff=c.backoff,
                               attempt_service=c.attempt_service,
                               fail_holds_frac=c.fail_holds_frac)
              for c in compiled]
    scen = ref_batching.stack_scenarios(
        padded, N, HORIZON,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)])
    if "attempt_service" not in scen:
        scen["attempt_service"] = np.repeat(cols["service"][..., None],
                                            A_SLOTS, -1)
    else:
        assert scen["attempt_service"].shape[3] == A_SLOTS
    scen.setdefault("fail_holds_frac", np.ones(R, np.float32))
    scen["n_attempt_slots"] = A_SLOTS
    return {**cols, **scen}, padded


def _compile(wls, scenario, resample_to_int=False):
    out = []
    for i, (wl, plat) in enumerate(zip(wls, platforms())):
        c = scenario.compile(wl, plat, HORIZON, seed=i)
        if resample_to_int and c.attempt_service is not None:
            # integer per-attempt durations keep the twin exact
            c = CompiledScenario(schedule=c.schedule, attempts=c.attempts,
                                 backoff=c.backoff,
                                 attempt_service=np.ceil(c.attempt_service),
                                 fail_holds_frac=c.fail_holds_frac)
        out.append(c)
    return out


_FLAKY = FailureModel(p_fail_by_type=(0.35,) * 6)   # retry (30, 2, 1800)
SCENARIOS = {
    # no scenario at all: the mixed-policy batch alone
    "plain": Scenario(),
    # a drain below the busy count on both pools: free goes negative
    "schedule": Scenario(capacity=MaintenanceWindows(
        ((40.0, 160.0, 0, 0.34), (90.0, 200.0, 1, 0.0)))),
    "retries": Scenario(failures=_FLAKY),
    "attempt_service": Scenario(failures=FailureModel(
        p_fail_by_type=(0.35,) * 6, resample_service=True)),
    "fail_holds_frac": Scenario(failures=FailureModel(
        p_fail_by_type=(0.35,) * 6, fail_holds_frac=0.5)),
}
MIXED = np.array([des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF,
                  des.POLICY_PRIORITY], np.int32)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_batch_matches_reference(name):
    """A mixed-policy batch under each scenario equals the reference
    ensemble in both admission modes and the numpy engine per replica."""
    wls = workloads(seed=1)
    compiled = _compile(wls, SCENARIOS[name], resample_to_int=True)
    if name != "plain":
        assert any(c.cap_times.shape[0] > 1 or c.attempts.max() > 1
                   for c in compiled), "the scenario must do something"
    cols, padded = _scenario_cols(wls, compiled)
    port = run_port(cols, policies=MIXED)
    keys = KEYS + ("att_start", "att_finish")
    for sort in ("pallas", "fused"):
        assert_same(port, run_ref(cols, sort, policies=MIXED), keys)
    assert_matches_des(port, wls, MIXED, padded)


def test_mixed_policies_equal_static_runs():
    """Each replica of a mixed-policy batch equals the static-policy run."""
    wls = workloads(seed=2)
    cols = ref_batching.pad_workloads(wls, platforms())
    mixed = run_port(cols, policies=MIXED)
    for p in np.unique(MIXED):
        static = run_port(cols, int(p))
        for i in np.nonzero(MIXED == p)[0]:
            assert_same({k: v[i] for k, v in mixed.items()},
                        {k: v[i] for k, v in static.items()})


def test_ragged_workloads_padded():
    """Workloads of different lengths padded by pad_workloads: padding rows
    arrive at PAD_ARRIVAL and run waves of their own (counted, as in the
    reference); the real rows equal the numpy engine, and batch_trace
    slices each entry back out as the reference's does."""
    wls = workloads(sizes=(30, 48, 41, 17), seed=3)
    cols, padded = _scenario_cols(wls, _compile(wls, SCENARIOS["retries"]))
    port = run_port(cols, policies=MIXED)
    ref = run_ref(cols, "pallas", policies=MIXED)
    assert_same(port, ref, KEYS + ("att_start", "att_finish"))
    assert_matches_des(port, wls, MIXED, padded, waves=False)
    assert port["done"].all()
    # slicing an entry back out drops the padding rows, as the reference
    for i, wl in enumerate(wls):
        got = batching.batch_trace(port, i, wl, capacities()[i])
        want = ref_batching.batch_trace(ref, i, wl, capacities()[i])
        for f in ("start", "finish", "ready", "attempts", "completed",
                  "att_start", "att_finish", "arrival", "capacities",
                  "waves"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


def test_host_sync_interval_is_inert():
    """K = 1 and K = 64 waves between host syncs give identical outputs:
    the waves a finished replica runs past its end change nothing."""
    wls = workloads(sizes=(48, 20, 35, 48), seed=4)
    cols, _ = _scenario_cols(wls, _compile(wls, SCENARIOS["retries"]))
    a = run_port(cols, policies=MIXED, sync_every=1)
    b = run_port(cols, policies=MIXED, sync_every=64)
    assert set(a) == set(b)
    assert_same(a, b, list(a))


def test_single_replica_views_match_batch():
    """``simulate`` (R = 1) and ``simulate_to_trace`` are views of the
    batch: the same replica gives the same tensors and trace."""
    wls = workloads(seed=5)
    compiled = _compile(wls, SCENARIOS["fail_holds_frac"])
    plat = platforms()[0]
    tr = vdes.simulate_to_trace(wls[0], plat, des.POLICY_SJF,
                                scenario=compiled[0], device="cpu")
    ref_tr = des.simulate(wls[0], plat, des.POLICY_SJF, scenario=compiled[0])
    live = np.arange(T)[None, :] < wls[0].n_tasks[:, None]
    for k in ("start", "finish", "ready"):
        np.testing.assert_array_equal(getattr(tr, k)[live],
                                      getattr(ref_tr, k)[live])
    np.testing.assert_array_equal(tr.att_start, ref_tr.att_start)
    np.testing.assert_array_equal(tr.completed, ref_tr.completed)
    assert tr.waves == ref_tr.waves


# ---------------------------------------------- non-integer (real) times

def test_generated_workload_matches_reference():
    """A 0.05-day generated workload (non-integer times) under failures
    with retries: the same waves and completions as the reference ensemble,
    and times within 4 f32 ulps of the largest finish time. The slack is
    XLA's: it may fuse the f32 stage arithmetic its own way (the port keeps
    every product rounded on its own), which moves a time by at most an
    ulp per operation; equal waves show no event was reordered."""
    horizon = 0.05 * 86400.0
    plat = RM.PlatformConfig()
    wls = [generate_empirical_workload(s, horizon) for s in (0, 1)]
    compiled = [Scenario(failures=FailureModel()).compile(
        wl, plat, horizon, seed=s) for s, wl in enumerate(wls)]
    cols = ref_batching.pad_workloads(wls, plat)
    cols.update(ref_batching.stack_scenarios(compiled, cols["n_max"],
                                             horizon))
    caps = np.tile(plat.capacities, (2, 1)).astype(np.int32)
    pols = np.array([des.POLICY_FIFO, des.POLICY_SJF], np.int32)
    port = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                  capacities=caps, policies=pols,
                                  device="cpu")
    ref = ref_vdes.simulate_ensemble(
        **{k: v for k, v in cols.items() if k != "n_max"}, capacities=caps,
        policies=pols, admission_sort="fused")
    for k in ("waves", "done", "attempts"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    fin = np.asarray(ref["finish"])
    tol = 4 * float(np.spacing(np.float32(np.nanmax(fin))))
    for k in ("start", "finish", "ready"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, equal_nan=True)

