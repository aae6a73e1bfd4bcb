"""The port's segment-restart hooks on ``simulate_ensemble`` (``resume``,
``wave_budget``, ``time_budget``, ``return_state``) against one call and
against the reference's hooks, on the CPU.

A run cut at wave budgets, or at a time guard, and resumed from the
returned ``state`` must equal one call **bit for bit** on every output key
(the wave counter included); a zero budget returns the initial state; and
at every cut the budget-free loop condition ``running`` and the count of
rows not DONE ``n_keep`` equal the reference's on the same integer-time
inputs, as its ``state``'s common keys equal the port's. The full-stack
case (controller, reliability, fleet with three same-model redeploys in
one wave, probe: ``chip_smoke.py``'s phase 14(b) ensemble) is cut every
few waves, so budgets stop replicas with pool rows about to finish.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import batching as ref_batching
from repro.core import des
from repro.core import vdes as ref_vdes
from repro.ops.failures import FailureModel, RetryPolicy
from repro.ops.scenario import Scenario
from repro_torch.core import batching, vdes
from test_des_engines import make_workload, platform

R, N, T, HORIZON = 3, 48, 3, 400.0
POLICIES = np.array([des.POLICY_FIFO, des.POLICY_SJF, des.POLICY_PRIORITY],
                    np.int32)
#: the reference's carry keys (the port's state has these and its own)
REF_KEYS = ("phase", "task_idx", "t_next", "enq_wave", "attempt", "free",
            "cap_idx", "wave", "start", "finish", "ready", "att_out",
            "att_start", "att_finish")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Integer-time workloads with retries and backoff (per-attempt
    records on), through the reference's host side."""
    rng = np.random.default_rng(20261017)
    plat = platform(3, 2)
    wls = [make_workload(rng, N - 4 * i, max_tasks=T, integer_time=True,
                         horizon=HORIZON) for i in range(R)]
    sc = Scenario(failures=FailureModel(
        p_fail_by_type=(0.3,) * 6,
        retry=RetryPolicy(max_retries=2, base_s=4.0, mult=2.0, cap_s=16.0)))
    comps = [sc.compile(w, plat, HORIZON, seed=i) for i, w in enumerate(wls)]
    cols = ref_batching.pad_workloads(wls, plat)
    cols.update(ref_batching.stack_scenarios(
        comps, cols["n_max"], HORIZON,
        services=[w.service_time(plat.datastore) for w in wls]))
    caps = np.tile(np.asarray(plat.capacities, np.int32)[None], (R, 1))
    return cols, caps


def port(case, **kw):
    cols, caps = case
    return vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                  capacities=caps, policies=POLICIES,
                                  device="cpu", **kw)


def ref(case, **kw):
    cols, caps = case
    cols = {k: v for k, v in cols.items() if k != "n_max"}
    return ref_vdes.simulate_ensemble(**cols, capacities=caps,
                                      policies=POLICIES, **kw)


def assert_outputs_equal(a, b):
    hooks = {"state", "running", "n_keep"}
    assert set(a) - hooks == set(b) - hooks, set(a) ^ set(b)
    for k in set(b) - hooks:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def assert_state_like_reference(got, want):
    """The port's carry, loop condition and kept-row count equal the
    reference's (the common keys of the carry)."""
    for k in REF_KEYS:
        np.testing.assert_array_equal(got["state"][k].numpy(),
                                      np.asarray(want["state"][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["running"].numpy(),
                                  np.asarray(want["running"]))
    np.testing.assert_array_equal(got["n_keep"].numpy(),
                                  np.asarray(want["n_keep"]))


def test_zero_budget_returns_initial_state(case):
    cols, _ = case
    zero = np.zeros(R, np.int32)
    got = port(case, wave_budget=zero, return_state=True)
    assert got["waves"].tolist() == [0] * R
    st = got["state"]
    assert (st["phase"] == vdes._NOT_ARRIVED).all()
    np.testing.assert_array_equal(st["t_next"].numpy(), cols["arrival"])
    assert torch.isnan(st["start"]).all() and torch.isnan(st["ready"]).all()
    assert got["running"].all()
    assert got["n_keep"].tolist() == [N] * R
    assert_state_like_reference(got, ref(case, wave_budget=zero,
                                         return_state=True))


@pytest.mark.parametrize("budgets", [(1, 2, 3), (17, 40, 64, 65),
                                     (5, 11, 200)])
def test_wave_budget_cut_and_resume_equals_one_call(case, budgets):
    """Cut at each budget in turn, resume from the returned state, then run
    to the end: equal to one call, and at each cut the state, ``running``
    and ``n_keep`` equal the reference's."""
    whole = port(case)
    st = None
    for b in budgets:
        wb = np.full(R, b, np.int32)
        got = port(case, resume=st, wave_budget=wb, return_state=True)
        assert (got["waves"] <= b).all()
        assert_state_like_reference(got, ref(case, wave_budget=wb,
                                             return_state=True))
        st = got["state"]
    assert_outputs_equal(port(case, resume=st), whole)


def test_time_budget_is_consistent_cut(case):
    """Stopping at a time guard and resuming equals the single call (the
    reference's ``test_time_budget_is_consistent_cut``)."""
    cols, _ = case
    whole = port(case)
    guard = np.full(R, float(np.median(cols["arrival"])), np.float32)
    part = port(case, time_budget=guard, return_state=True)
    assert (part["waves"] <= whole["waves"]).all()
    assert (part["waves"] > 0).all()
    assert_state_like_reference(part, ref(case, time_budget=guard,
                                          return_state=True))
    assert_outputs_equal(port(case, resume=part["state"]), whole)


def test_per_replica_budgets_freeze_each_replica(case):
    """Replicas stop at their own budgets while the others run on."""
    wb = np.array([0, 7, 10 ** 6], np.int32)
    got = port(case, wave_budget=wb, return_state=True)
    whole = port(case)
    assert got["waves"].tolist()[:2] == [0, 7]
    assert int(got["waves"][2]) == int(whole["waves"][2])
    assert got["running"].tolist() == [True, True, False]
    assert_state_like_reference(got, ref(case, wave_budget=wb,
                                         return_state=True))


def test_resume_needs_every_state_key(case):
    st = port(case, wave_budget=np.zeros(R, np.int32),
              return_state=True)["state"]
    del st["enq_wave"]
    with pytest.raises(KeyError):
        port(case, resume=st)


@pytest.fixture(scope="module")
def fullstack():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cols, caps, pols = mod.fullstack_oracle_ensemble()[:3]
    return batching.to_tensors(cols, "cpu"), caps, pols, mod.FSO_BURST


@pytest.mark.parametrize("step,sync_every", [(16, 32), (45, 64)])
def test_full_stack_cut_every_few_waves_equals_one_call(fullstack, step,
                                                         sync_every):
    """Every stage on: cut every few waves (replica ``r``'s budget its own
    wave plus ``step + r``, so replicas stop at different waves and run
    frozen until the loop's next host read) and resume, to the end: equal
    to one call on all output keys, the burst replica's three same-model
    redeploys in one wave included."""
    kw, caps, pols, burst = fullstack
    stagger = torch.arange(len(pols), dtype=torch.int32) + step

    def run(**hooks):
        return vdes.simulate_ensemble(**kw, capacities=caps, policies=pols,
                                      device="cpu", **hooks)

    whole = run()
    st = run(wave_budget=np.zeros(len(pols), np.int32),
             return_state=True)["state"]
    n_calls = 0
    while True:
        got = run(resume=st, wave_budget=st["wave"] + stagger,
                  return_state=True, sync_every=sync_every)
        st, n_calls = got["state"], n_calls + 1
        if not got["running"].any():
            break
    assert n_calls >= int(whole["waves"].max()) // (step + len(pols))
    assert_outputs_equal(got, whole)
    acts = whole["fleet_act"][burst][:int(whole["fleet_n"][burst])]
    assert int((acts[:, 1] == des.FLEET_ACT_REDEPLOY).sum()) == 3
