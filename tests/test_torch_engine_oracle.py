"""``chip_smoke.py`` phase 13's and phase 14(b)'s ensembles through the
port's CPU path against the reference's numpy engine, on the CPU.

Phase 13 (and ``tests/test_torch_cuda.py``'s card test) holds the card's
engine bit for bit against the port's CPU path on this ensemble; this test
holds that CPU path bit for bit against ``repro.core.des.simulate``, replica
by replica, so the card's answer is the oracle's. The ensemble: four
one-tenth-day ground-truth workloads with whole-second times
(``whole_seconds``), mixed policies, retries with backoff, a
partial-progress replica, a resampled-attempt replica and drains below the
busy count. Phase 14(b)'s adds every stage of the wave loop (controller,
reliability, fleet, probe) under the reference's parity conditions.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import des as ref_des
from repro.core import model as RM
from repro.ops.capacity import CapacitySchedule as RefSchedule
from repro.ops.scenario import CompiledScenario as RefCompiled
from repro_torch.core import batching, vdes
from repro_torch.core import model as M
from repro_torch.core.workload import generate_empirical_workload, whole_seconds


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_whole_seconds_keeps_service_and_rounds_up():
    """Every time a whole number, each no smaller than the original, the
    service time equal to the execution time (no I/O), padding untouched."""
    ds = M.PlatformConfig().datastore
    wl = generate_empirical_workload(3, 7200.0)
    ws = whole_seconds(wl, ds)
    live = wl.task_type >= 0
    svc = ws.service_time(ds)
    assert np.array_equal(ws.arrival, np.ceil(ws.arrival))
    assert np.array_equal(svc, np.ceil(svc))
    assert (ws.arrival >= wl.arrival).all()
    assert (svc[live] >= wl.service_time(ds)[live]).all()
    assert (svc[~live] == 0).all()
    assert np.array_equal(svc, ws.exec_time)
    assert np.array_equal(ws.task_res, wl.task_res)


def _reference_scenario(c, K, horizon):
    sched = c.schedule.padded(K, horizon)
    return RefCompiled(schedule=RefSchedule(sched.times, sched.caps),
                       attempts=c.attempts, backoff=c.backoff,
                       attempt_service=c.attempt_service,
                       fail_holds_frac=c.fail_holds_frac)


def test_oracle_ensemble_cpu_path_equals_numpy_engine(chip_smoke):
    """Each replica's start/finish/ready, executed attempts, per-attempt
    records and completion equal ``des.simulate``'s exactly, and so does
    the wave count of the replicas that need no padding rows (a padding
    row arrives at ``PAD_ARRIVAL`` and runs waves of its own, which the
    numpy engine never sees); every replica retries (phase 13's
    precondition)."""
    cols, caps, pols, wls, comps, plat = chip_smoke.oracle_ensemble()
    out = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                 capacities=caps, policies=pols,
                                 device="cpu")
    assert set(out) == set(chip_smoke.ORACLE_KEYS)
    assert (out["attempts"].amax(dim=(1, 2)) > 1).all()
    ref_plat = RM.PlatformConfig().with_capacity(
        "learning_cluster", chip_smoke.ORACLE_LEARNING_CAP)
    assert np.array_equal(ref_plat.capacities, plat.capacities)
    K = cols["cap_times"].shape[1]
    horizon = chip_smoke.ORACLE_HORIZON_S
    unpadded = 0
    for i, (wl, c) in enumerate(zip(wls, comps)):
        rwl = RM.Workload(**{f.name: getattr(wl, f.name)
                             for f in dataclasses.fields(wl)})
        tr = ref_des.simulate(rwl, ref_plat, int(pols[i]),
                              scenario=_reference_scenario(c, K, horizon))
        n = wl.n
        live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
        for k in ("start", "finish", "ready"):
            got = out[k][i, :n].numpy().astype(np.float64)
            np.testing.assert_array_equal(got[live], getattr(tr, k)[live],
                                          err_msg=f"replica {i} {k}")
        np.testing.assert_array_equal(out["attempts"][i, :n].numpy()[live],
                                      tr.attempts[live])
        np.testing.assert_array_equal(out["done"][i, :n].numpy(),
                                      tr.completed)
        A = tr.att_start.shape[2]
        for k in ("att_start", "att_finish"):
            got = out[k][i, :n].numpy().astype(np.float64)
            np.testing.assert_array_equal(got[live][:, :A],
                                          getattr(tr, k)[live])
        if n == cols["n_max"]:
            assert int(out["waves"][i]) == tr.waves, f"replica {i} waves"
            unpadded += 1
    assert unpadded >= 1


def test_fullstack_oracle_ensemble_cpu_path_equals_numpy_engine(chip_smoke):
    """``chip_smoke.py`` phase 14(b)'s ensemble (every stage on: the
    controller, reliability events, the fleet and the probe, with padding
    rows on one replica and three same-model redeploys in one of its waves)
    through the port's CPU path: each replica's task times, attempts,
    completion, realized controller and reliability timelines, fleet
    timelines and actions, pool activations and telemetry equal
    ``des.simulate``'s exactly, and so do the wave counts of the replicas
    that need no padding rows."""
    cols, caps, pols, wls, comps, fleets, probes, rels, plat = \
        chip_smoke.fullstack_oracle_ensemble()
    out = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                 capacities=caps, policies=pols,
                                 device="cpu")
    assert set(out) == set(chip_smoke.FSO_KEYS)
    counts = chip_smoke.fullstack_counts(out)
    ref_plat = RM.PlatformConfig().with_capacity(
        "learning_cluster", chip_smoke.FSO_LEARNING_CAP)
    K = cols["cap_times"].shape[1]
    horizon = chip_smoke.ORACLE_HORIZON_S
    unpadded = 0
    for i, wl in enumerate(wls):
        c = comps[i]
        rc = dataclasses.replace(_reference_scenario(c, K, horizon),
                                 controller=c.controller)
        rwl = RM.Workload(**{f.name: getattr(wl, f.name)
                             for f in dataclasses.fields(wl)})
        tr = ref_des.simulate(rwl, ref_plat, int(pols[i]), scenario=rc,
                              fleet=fleets[i], probe=probes[i],
                              reliability=rels[i])
        got = batching.batch_trace(out, i, wl, plat.capacities,
                                   fleet=fleets[i], probe=probes[i],
                                   reliability=rels[i])
        for k in ("start", "finish", "ready", "attempts", "completed",
                  "arrival", "ctrl_times", "ctrl_caps", "rel_times",
                  "rel_caps", "fleet_perf", "fleet_stale", "fleet_times",
                  "fleet_kind", "fleet_model", "probe_vals"):
            want = getattr(tr, k)
            if want is None:
                continue
            np.testing.assert_array_equal(getattr(got, k), want,
                                          err_msg=f"replica {i} {k}")
        if wl.n == cols["n_max"]:
            assert got.waves == tr.waves, f"replica {i} waves"
            unpadded += 1
        if i != chip_smoke.FSO_BURST:
            assert counts[i]["ctrl_actions"] > 0
    assert unpadded >= 1
    assert counts[0]["rel_events"] > 0 and counts[1]["rel_events"] > 0
    assert all(c["redeploys"] > 0 for c in counts)
    burst = out["fleet_act"][chip_smoke.FSO_BURST].numpy()
    burst = burst[:int(out["fleet_n"][chip_smoke.FSO_BURST])]
    rede = burst[burst[:, 1] == 1, 0]
    assert rede.shape[0] == 3 and len(set(rede.tolist())) == 1
