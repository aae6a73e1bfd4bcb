"""The port's host-side copies give the reference's results bit for bit.

Workload generation, scenario compilation, padding/stacking, trace
flattening and the summary (with a capacity schedule, an SLO and cost
rates) run in both packages on the same inputs and must agree exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import batching as ref_batching
from repro.core import des
from repro.core import model as RM
from repro.core import trace as ref_trace
from repro.core import workload as ref_workload
from repro.ops import accounting as ref_acc
from repro.ops import capacity as ref_cap
from repro.ops import failures as ref_fail
from repro.ops import scenario as ref_scen
from repro_torch.core import batching, trace, workload
from repro_torch.core import model as TM
from repro_torch.ops import accounting, capacity, failures, scenario

HORIZON = 0.1 * 86400.0


def assert_tree_equal(a, b, path="out"):
    """Dicts, dataclasses, arrays and scalars equal exactly (NaN == NaN)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


def _scenarios(mod_cap, mod_fail, mod_scen):
    """One scenario per capacity policy, with failures, resampled retries,
    partial-progress failures and outages."""
    return [
        mod_scen.Scenario(),
        mod_scen.Scenario(
            capacity=mod_cap.MaintenanceWindows(
                ((3600.0, 5400.0, 1, 0.5), (600.0, 900.0, 0, 0.0))),
            failures=mod_fail.FailureModel(resample_service=True)),
        mod_scen.Scenario(
            capacity=mod_cap.ScheduledAutoscaler(resources=(1,)),
            failures=mod_fail.FailureModel(fail_holds_frac=0.5),
            outages=mod_fail.OutageModel(mtbf_s=3 * 3600.0)),
    ]


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_empirical_workload(seed):
    a = ref_workload.generate_empirical_workload(seed, HORIZON)
    b = workload.generate_empirical_workload(seed, HORIZON)
    assert a.n > 0
    for f in dataclasses.fields(a):
        assert_tree_equal(getattr(a, f.name), getattr(b, f.name), f.name)
    for f in ("asset_rows", "asset_cols", "asset_bytes"):
        assert_tree_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(ref_workload.hour_of_week_weights(),
                                  workload.hour_of_week_weights())


def test_scenario_compile():
    wl = workload.generate_empirical_workload(1, HORIZON)
    plat_r, plat_t = RM.PlatformConfig(), TM.PlatformConfig()
    for i, (sa, sb) in enumerate(zip(
            _scenarios(ref_cap, ref_fail, ref_scen),
            _scenarios(capacity, failures, scenario))):
        a = sa.compile(wl, plat_r, HORIZON, seed=i)
        b = sb.compile(wl, plat_t, HORIZON, seed=i)
        assert a.controller is None
        for k in ("cap_times", "cap_vals", "attempts", "backoff",
                  "attempt_service", "fail_holds_frac"):
            assert_tree_equal(getattr(a, k), getattr(b, k), k)
    assert_tree_equal(ref_scen.compile_static(wl, plat_r).attempts,
                      scenario.compile_static(wl, plat_t).attempts)


def test_pad_and_stack():
    plat_r, plat_t = RM.PlatformConfig(), TM.PlatformConfig()
    wls = [workload.generate_empirical_workload(s, HORIZON)
           for s in (0, 1, 2)]
    assert len({w.n for w in wls}) > 1                 # ragged
    assert_tree_equal(ref_batching.pad_workloads(wls, plat_r),
                      batching.pad_workloads(wls, plat_t))
    n_max = max(w.n for w in wls)
    comp_r = [s.compile(w, plat_r, HORIZON, seed=i) for i, (s, w) in
              enumerate(zip(_scenarios(ref_cap, ref_fail, ref_scen), wls))]
    comp_t = [s.compile(w, plat_t, HORIZON, seed=i) for i, (s, w) in
              enumerate(zip(_scenarios(capacity, failures, scenario), wls))]
    services = [w.service_time(plat_r.datastore) for w in wls]
    for record in (True, False):
        assert_tree_equal(
            ref_batching.stack_scenarios(comp_r, n_max, HORIZON, services,
                                         record_attempts=record),
            batching.stack_scenarios(comp_t, n_max, HORIZON, services,
                                     record_attempts=record))
    assert_tree_equal(
        ref_scen.stack_compiled_scenarios(comp_r, n_max, HORIZON, services),
        scenario.stack_compiled_scenarios(comp_t, n_max, HORIZON, services))
    # the carry onto the device keeps every value, in the engine's dtypes
    cols = ref_batching.stack_scenarios(comp_r, n_max, HORIZON, services)
    t = batching.to_tensors(cols, "cpu")
    assert t["n_attempt_slots"] == cols["n_attempt_slots"]
    for k, v in t.items():
        if k != "n_attempt_slots":
            np.testing.assert_array_equal(v.numpy(), cols[k])
            assert v.numpy().dtype == np.asarray(cols[k]).dtype, k


def test_flatten_and_summarize(tmp_path):
    """Records and the summary (schedule, SLO, cost) from one numpy-engine
    trace equal the reference's, column for column and key for key."""
    plat = RM.PlatformConfig(resources=(
        RM.ResourceConfig("compute_cluster", 8, 0.5),
        RM.ResourceConfig("learning_cluster", 4, 3.0)))
    wl = ref_workload.generate_empirical_workload(2, HORIZON)
    comp = _scenarios(ref_cap, ref_fail, ref_scen)[1].compile(
        wl, plat, HORIZON, seed=2)
    tr = des.simulate(wl, plat, des.POLICY_SJF, scenario=comp)
    port_tr = TM.SimTrace(**{f.name: getattr(tr, f.name)
                             for f in dataclasses.fields(TM.SimTrace)})
    rec_r = ref_trace.flatten_trace(tr, wl)
    rec_t = trace.flatten_trace(port_tr, wl)
    assert rec_t.att_start is not None and (rec_t.attempts > 1).any()
    assert_tree_equal(rec_r, rec_t)
    sched_t = capacity.CapacitySchedule(comp.schedule.times,
                                        comp.schedule.caps)
    caps = plat.capacities
    assert_tree_equal(
        ref_trace.summarize(rec_r, caps, HORIZON, schedule=comp.schedule,
                            cost_rates=plat.cost_rates,
                            slo=ref_acc.SLOConfig(3600.0, 300.0)),
        trace.summarize(rec_t, caps, HORIZON, schedule=sched_t,
                        cost_rates=plat.cost_rates,
                        slo=accounting.SLOConfig(3600.0, 300.0)))
    assert_tree_equal(ref_trace.summarize(rec_r, caps, HORIZON),
                      trace.summarize(rec_t, caps, HORIZON))
    assert_tree_equal(
        ref_trace.utilization_timeline(rec_r, caps, 1800.0, HORIZON,
                                       schedule=comp.schedule),
        trace.utilization_timeline(rec_t, caps, 1800.0, HORIZON,
                                   schedule=sched_t))
    assert_tree_equal(ref_trace.queue_length_timeline(rec_r, 2, 1800.0),
                      trace.queue_length_timeline(rec_t, 2, 1800.0))
    path = str(tmp_path / "records.npz")
    rec_t.save(path)
    assert_tree_equal(trace.TaskRecords.load(path), rec_t)
    half = rec_t.pipeline < rec_t.pipeline.max() // 2
    parts = [trace.TaskRecords(**{
        f.name: None if getattr(rec_t, f.name) is None
        else getattr(rec_t, f.name)[m]
        for f in dataclasses.fields(trace.TaskRecords)})
        for m in (half, ~half)]
    assert_tree_equal(trace.concat_records(parts).att_start,
                      rec_t.att_start[np.concatenate(
                          [np.nonzero(half)[0], np.nonzero(~half)[0]])])
