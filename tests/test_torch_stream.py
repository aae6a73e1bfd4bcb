"""The port's streaming driver (``repro_torch.stream``), its sources and the
``"torch-stream"`` engine, against the JAX package, on the CPU.

Twins on pinned integer-time sources (a numpy workload served as
fixed-size blocks, the same blocks to both packages): the port's
``stream_simulate`` must give drift 0.0 (``parity_drift``) against the
reference's ``oneshot_reference`` and equal the reference's own
``stream_simulate`` — the records, the wave count, the window count and
the working width — plain, with a failure scenario and a closed-loop
controller, at irregular window cuts (on arrival times too) and
property-based. The reference's JAX fleet path fails on this tree, so
with a fleet and a probe the port's stream is held against the port's
one-shot run, and that one against the reference's numpy engine
``des.simulate`` fed the same compiled scenario, fleet and probe (drift
0.0, the waves included). ``overlap`` on and off give the same bits.

``SyntheticSource`` draws with the port's generators (not JAX's keys), so
it is checked for determinism, prefix stability and ``until_s``, not
against the reference's draws. ``WorkloadManager``, ``concat_records`` and
``StreamAccumulator`` equal the reference's on the same inputs. The
reference's test that counts JAX compiles per window
(``test_stream_window_calls_share_one_signature``) has no counterpart: the
port compiles nothing.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import stream as ref_stream
from repro.core import des as ref_des
from repro.core import model as RM
from repro.core import runtime as ref_rt
from repro.core import trace as ref_trace
from repro.obs import probes as ref_probes
from repro.ops import accounting as ref_acc
from repro.ops import capacity as ref_cap
from repro.ops import failures as ref_fail
from repro.ops import scenario as ref_scen
from repro.stream import driver as ref_driver
from repro_torch import stream
from repro_torch.core import experiment, runtime, trace
from repro_torch.core import model as M
from repro_torch.core.fitting import SimulationParams
from repro_torch.obs import probes
from repro_torch.ops import accounting, capacity, failures, scenario
from repro_torch.reliability import ReliabilitySpec
from test_compaction import TRIG, fleet_tensor
from test_des_engines import make_workload, platform

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "pipesim_params.npz"
REC_FIELDS = ("pipeline", "task_pos", "task_type", "resource", "arrival",
              "ready", "start", "finish", "attempts", "pipeline_done",
              "att_start", "att_finish")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ListSource:
    """A pinned workload served as fixed-size arrival-ordered blocks of
    ``mod``'s (the port's or the reference's) ``Workload``."""

    def __init__(self, wl, mod=M, block=16, name="list"):
        self.wl, self.mod, self.block, self.name = wl, mod, block, name

    def blocks(self):
        n = self.wl.arrival.shape[0]
        for lo in range(0, n, self.block):
            hi = min(lo + self.block, n)
            yield self.mod.Workload(**{
                f.name: (v[lo:hi] if isinstance(
                    v := getattr(self.wl, f.name), np.ndarray) else v)
                for f in dataclasses.fields(RM.Workload)})


def plats():
    rp = platform()
    return rp, M.PlatformConfig(resources=tuple(
        M.ResourceConfig(r.name, r.capacity, r.cost_per_node_hour)
        for r in rp.resources))


def scen(mod_scen, mod_fail, mod_cap, resample=True):
    return mod_scen.Scenario(
        name="ops",
        failures=mod_fail.FailureModel(
            p_fail_by_type=(0.3,) * 6,
            retry=mod_fail.RetryPolicy(max_retries=2, base_s=4.0, mult=2.0,
                                       cap_s=16.0),
            resample_service=resample),
        controller=mod_cap.ReactiveController(
            high_watermark=0.3, step=0.5, max_scale=4.0, interval_s=50.0))


def scenarios(on, resample=True):
    if not on:
        return None, None
    return (scen(scenario, failures, capacity, resample),
            scen(ref_scen, ref_fail, ref_cap, resample))


def assert_same_records(a, b):
    for f in REC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)


def twin(wl, horizon, n_windows=None, window_s=None, seed=3, block=16,
         with_scenario=False):
    """The port's stream against the reference's one-shot run (drift 0.0)
    and the reference's stream (records, waves, windows, width)."""
    rp, pp = plats()
    psc, rsc = scenarios(with_scenario)
    ws = window_s if window_s is not None else horizon / n_windows
    ref = ref_stream.oneshot_reference(ListSource(wl, RM, block), rp,
                                       horizon_s=horizon, seed=seed,
                                       scenario=rsc)
    sr = stream.stream_simulate(ListSource(wl, M, block), pp,
                                horizon_s=horizon, window_s=ws, seed=seed,
                                min_rows=16, scenario=psc, device="cpu")
    assert stream.parity_drift(sr, ref) == 0.0
    assert sr.waves == int(ref["trace"].waves)
    rsr = ref_stream.stream_simulate(ListSource(wl, RM, block), rp,
                                     horizon_s=horizon, window_s=ws,
                                     seed=seed, min_rows=16, scenario=rsc)
    assert_same_records(sr.records, rsr.records)
    assert (sr.waves, sr.n_windows, sr.peak_rows, sr.peak_live,
            sr.n_pipelines, sr.n_task_rows) == (
        rsr.waves, rsr.n_windows, rsr.peak_rows, rsr.peak_live,
        rsr.n_pipelines, rsr.n_task_rows)
    return sr, ref


@pytest.mark.parametrize("n_windows", [1, 3, 5])
def test_stream_twin_plain(n_windows):
    wl = make_workload(np.random.default_rng(20260807), 60,
                       integer_time=True, horizon=900.0)
    sr, _ = twin(wl, 1000.0, n_windows)
    assert sr.n_windows == n_windows and sr.n_pipelines == 60
    if n_windows == 5:
        assert sr.peak_rows < 60      # the working set is the backlog


@pytest.mark.parametrize("n_windows", [2, 4])
def test_stream_twin_scenario_controller(n_windows):
    wl = make_workload(np.random.default_rng(20260808), 60,
                       integer_time=True, horizon=900.0)
    sr, ref = twin(wl, 1000.0, n_windows, with_scenario=True)
    assert sr.ctrl_times is not None and len(sr.ctrl_times) > 0
    assert sr.records.att_start is not None


@pytest.mark.parametrize("window_s", [170.0, 123.456, 77.0])
def test_stream_twin_irregular_cuts(window_s):
    """Windows that do not divide the horizon, cuts on integer arrival
    times (f32 boundary ties) and cuts that never land on one."""
    wl = make_workload(np.random.default_rng(20260809), 40,
                       integer_time=True, horizon=500.0)
    twin(wl, 600.0, window_s=window_s, seed=1, block=9)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 50), n_windows=st.integers(1, 9),
       block=st.integers(3, 40))
def test_stream_twin_property(seed, n_windows, block):
    """Any (workload seed, window count, ingest block size) twins."""
    wl = make_workload(np.random.default_rng(seed), 30, integer_time=True,
                       horizon=400.0)
    twin(wl, 500.0, n_windows, seed=seed, block=block,
         with_scenario=bool(seed % 2))


def numpy_oneshot(wl, plat, horizon, seed, rsc, fleet, trig, probe):
    """The reference's one-shot plan (per-block failure draws, the pool's
    own draws, the fleet and probe compiles) through the numpy engine
    ``des.simulate`` instead of its JAX engine."""
    plan = ref_driver._StreamPlan(plat, 0, rsc, fleet, trig, probe,
                                  horizon, seed, None, "fused")
    src = ListSource(wl, RM, 12)
    blocks = list(src.blocks())
    draws = [plan.block_attempts(b, i) for i, b in enumerate(blocks)]
    cf, ext = ref_scen.compile_fleet(fleet, trig, wl, plat, horizon,
                                     seed=seed)
    pool = plan.scenario.compile(
        ref_driver._rows_workload(ext, wl.n), plat, horizon,
        seed=ref_driver._block_seed(seed, ref_driver._POOL_SALT),
        schedule=plan.schedule)
    comp = ref_scen.CompiledScenario(
        schedule=plan.schedule, backoff=plan.backoff,
        attempts=np.concatenate([a for a, _ in draws] + [pool.attempts]),
        controller=plan.controller, fail_holds_frac=plan.holds_frac)
    return ref_des.simulate(ext, plat, 0, scenario=comp, fleet=cf,
                            probe=plan.probe)


@pytest.mark.parametrize("n_windows", [1, 3, 5])
def test_stream_full_stack_equals_oneshot_and_numpy_engine(n_windows):
    """Controller, retries (at whole-second durations: no resampling, so
    f32 and the numpy engine's f64 agree), a fleet with its trigger and a
    probe: the port's stream equals the port's one-shot run on every
    comparable tensor, and that one-shot run equals the numpy engine on
    the records, the controller, fleet and probe timelines and the wave
    count."""
    wl = make_workload(np.random.default_rng(20260807), 50,
                       integer_time=True, horizon=300.0)
    rp, pp = plats()
    psc, rsc = scenarios(True, resample=False)
    trig = runtime.TriggerSpec(**{f.name: getattr(TRIG, f.name)
                                  for f in dataclasses.fields(TRIG)})
    kw = dict(scenario=psc, fleet=runtime.FleetSpec(params=fleet_tensor()),
              trigger=trig, probe=probes.ProbeSpec(interval_s=40.0),
              horizon_s=400.0, seed=3)
    one = stream.oneshot_reference(ListSource(wl, M, 12), pp, device="cpu",
                                   **kw)
    sr = stream.stream_simulate(ListSource(wl, M, 12), pp, device="cpu",
                                window_s=400.0 / n_windows, min_rows=16,
                                **kw)
    assert stream.parity_drift(sr, one) == 0.0
    assert sr.waves == int(one["trace"].waves)
    assert sr.probe_vals is not None and sr.fleet_cols is not None
    assert int((sr.fleet_cols["fleet_kind"] == 1).sum()) > 0   # redeploys
    tr = numpy_oneshot(wl, rp, 400.0, 3, rsc,
                       ref_rt.FleetSpec(params=fleet_tensor()), TRIG,
                       ref_probes.ProbeSpec(interval_s=40.0))
    got = one["trace"]
    for f in ("start", "finish", "ready", "attempts", "completed",
              "att_start", "att_finish", "arrival", "ctrl_times",
              "ctrl_caps", "probe_vals", "fleet_perf", "fleet_stale",
              "fleet_times", "fleet_kind", "fleet_model"):
        want = getattr(tr, f)
        have = np.asarray(getattr(got, f))
        if f in ("att_start", "att_finish"):
            have = have[..., :want.shape[-1]]
        np.testing.assert_array_equal(have, want, err_msg=f)
    assert got.waves == tr.waves


def test_stream_overlap_toggle_identical():
    """Staging beside the window or after it: the same bits."""
    wl = make_workload(np.random.default_rng(20260810), 50,
                       integer_time=True, horizon=500.0)
    _, pp = plats()
    psc, _ = scenarios(True)
    a, b = (stream.stream_simulate(ListSource(wl), pp, horizon_s=600.0,
                                   window_s=200.0, seed=2, min_rows=16,
                                   scenario=psc, overlap=ov, device="cpu")
            for ov in (True, False))
    assert_same_records(a.records, b.records)
    assert a.waves == b.waves and a.n_windows == b.n_windows == 3
    np.testing.assert_array_equal(a.ctrl_times, b.ctrl_times)


# ------------------------------------------------------------- sources

@pytest.fixture(scope="module")
def params():
    return SimulationParams.load(str(ARTIFACT), device="cpu")


def test_synthetic_source_deterministic(params):
    """Block b is a function of (params, seed, block size, b, clock):
    re-iteration gives the same bits, and a longer stream extends a shorter
    one without rewriting its prefix; another seed draws another stream."""
    src = stream.SyntheticSource(params, seed=11, block_size=64, n_blocks=4,
                                 device="cpu")
    w1, w2 = stream.materialize(src), stream.materialize(src)
    for f in dataclasses.fields(M.Workload):
        np.testing.assert_array_equal(getattr(w1, f.name),
                                      getattr(w2, f.name), err_msg=f.name)
    longer = stream.materialize(stream.SyntheticSource(
        params, seed=11, block_size=64, n_blocks=6, device="cpu"))
    n = w1.arrival.shape[0]
    assert longer.arrival.shape[0] == 6 * 64 > n == 4 * 64
    np.testing.assert_array_equal(longer.arrival[:n], w1.arrival)
    np.testing.assert_array_equal(longer.exec_time[:n], w1.exec_time)
    assert np.all(np.diff(longer.arrival) >= 0)
    other = stream.materialize(stream.SyntheticSource(
        params, seed=12, block_size=64, n_blocks=4, device="cpu"))
    assert not np.array_equal(other.arrival, w1.arrival)


def test_synthetic_source_until_s(params):
    wl = stream.materialize(stream.SyntheticSource(
        params, seed=5, block_size=32, until_s=3600.0, device="cpu"))
    # every block STARTS before the bound; the crossing block comes whole
    assert wl.arrival[0] < 3600.0 <= wl.arrival[-1]
    assert wl.arrival.shape[0] % 32 == 0
    assert wl.arrival[-33] < 3600.0


def test_synthetic_source_needs_a_card_unless_asked(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(stream.SyntheticSource(params, n_blocks=1).blocks())


def test_workload_manager_take_until():
    """The port's ingestion buffer cuts on the engine clock's f32 cast and
    serves the same segments as the reference's."""
    wl = make_workload(np.random.default_rng(20260811), 40,
                       integer_time=True, horizon=400.0)
    wm = stream.WorkloadManager(ListSource(wl, M, 7))
    rwm = ref_stream.WorkloadManager(ListSource(wl, RM, 7))
    for t in (150.0, 150.0, 233.5, 1e9):
        got, want = wm.take_until(t), rwm.take_until(t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert wm.exhausted and wm.take_until(1e9) == []
    assert wm.n_rows == rwm.n_rows == 40 and wm.n_blocks == rwm.n_blocks


def _mini_rec(mod, n, width=None, base=0):
    start = np.arange(n, dtype=np.float64) + base
    att_s = att_f = None
    if width is not None:
        att_s = np.full((n, width), np.nan)
        att_s[:, 0] = start
        att_f = att_s + 1.0
    return mod.TaskRecords(
        pipeline=np.arange(n, dtype=np.int64) + base,
        task_pos=np.zeros(n, np.int64), task_type=np.zeros(n, np.int64),
        resource=np.zeros(n, np.int64), arrival=start.copy(),
        ready=start.copy(), start=start, finish=start + 1.0,
        read_bytes=np.zeros(n), write_bytes=np.zeros(n),
        framework=np.zeros(n, np.int64),
        pipeline_done=np.ones(n, bool), attempts=np.ones(n, np.int64),
        att_start=att_s, att_finish=att_f)


def test_concat_records_ragged_attempt_widths():
    """Batches of attempt widths 2 and 3 and one without the columns
    concatenate as the reference's: narrow batches right-pad with NaN,
    column-less rows contribute (start, finish) in slot 0."""
    parts = [(2, 0), (3, 3), (None, 5)]
    cat = trace.concat_records([_mini_rec(trace, n_, w, b) for n_, (w, b)
                                in zip((3, 2, 2), parts)])
    want = ref_trace.concat_records([_mini_rec(ref_trace, n_, w, b)
                                     for n_, (w, b) in zip((3, 2, 2), parts)])
    assert cat.att_start.shape == (7, 3)
    assert_same_records(cat, want)
    np.testing.assert_array_equal(cat.att_start[5:, 0], cat.start[5:])
    whole = accounting.busy_node_seconds(cat, 1)
    np.testing.assert_allclose(whole, ref_acc.busy_node_seconds(want, 1))
    assert trace.concat_records([_mini_rec(trace, 2),
                                 _mini_rec(trace, 2, base=2)]
                                ).att_start is None


def test_stream_accumulator_matches_reference_and_summarize():
    wl = make_workload(np.random.default_rng(20260812), 60,
                       integer_time=True, horizon=900.0)
    rp, pp = plats()
    acc = accounting.StreamAccumulator(pp.capacities, 1000.0,
                                       slo=accounting.SLOConfig())
    sr = stream.stream_simulate(ListSource(wl), pp, horizon_s=1000.0,
                                window_s=250.0, seed=3, min_rows=16,
                                sink=acc.add, device="cpu")
    assert sr.records is None and acc.n_batches > 1
    racc = ref_acc.StreamAccumulator(rp.capacities, 1000.0,
                                     slo=ref_acc.SLOConfig())
    rsr = ref_stream.stream_simulate(ListSource(wl, RM), rp,
                                     horizon_s=1000.0, window_s=250.0,
                                     seed=3, min_rows=16, sink=racc.add)
    assert rsr.records is None
    got, want = acc.summary(), racc.summary()
    assert got == want
    one = stream.oneshot_reference(ListSource(wl), pp, horizon_s=1000.0,
                                   seed=3, device="cpu")
    ref = one["summary"]
    assert got["n_tasks"] == ref["n_tasks"]
    assert got["n_pipelines"] == ref["n_pipelines"]
    assert got["mean_wait_s"] == pytest.approx(ref["mean_wait_s"], abs=1e-9)
    for r in got["utilization"]:
        assert got["utilization"][r] == pytest.approx(
            ref["utilization"][r], abs=1e-12)
    waits = one["records"].wait
    for q, name in ((50, "p50_wait_s"), (95, "p95_wait_s"),
                    (99, "p99_wait_s")):
        lo = float(np.nanpercentile(waits, q, method="lower"))
        hi = float(np.nanpercentile(waits, q, method="higher"))
        assert lo * 0.98 - 1e-9 <= got[name] <= hi * 1.02 + 1e-9, name


# ------------------------------------------------------- engine plumbing

def test_torch_stream_engine_equals_torch():
    """``"torch-stream"`` against ``"torch"`` and ``"torch-compact"``, which
    materialize the same source, and against the reference's
    ``"jax-stream"``."""
    from repro.core import experiment as ref_exp
    wl = make_workload(np.random.default_rng(20260813), 50,
                       integer_time=True, horizon=500.0)
    rp, pp = plats()
    spec = experiment.ExperimentSpec(name="s", platform=pp, horizon_s=600.0,
                                     seed=3, engine="torch-stream",
                                     source=ListSource(wl))
    a = experiment.run_experiment(spec, device="cpu")
    assert a.summary["n_windows"] >= 1
    want = ref_exp.run_experiment(ref_exp.ExperimentSpec(
        name="s", platform=rp, horizon_s=600.0, seed=3, engine="jax-stream",
        source=ListSource(wl, RM)))
    assert_same_records(a.records, want.records)
    for eng in ("torch", "torch-compact"):
        b = experiment.run_experiment(spec.with_(engine=eng), device="cpu")
        o = np.lexsort((b.records.task_pos, b.records.pipeline))
        for f in ("pipeline", "task_pos", "start", "finish", "ready"):
            np.testing.assert_array_equal(getattr(a.records, f),
                                          getattr(b.records, f)[o],
                                          err_msg=f"{eng} {f}")
        assert a.summary["n_tasks"] == b.summary["n_tasks"]


def test_torch_stream_engine_refuses_replicas_and_reliability():
    wl = make_workload(np.random.default_rng(0), 10, integer_time=True,
                       horizon=200.0)
    spec = experiment.ExperimentSpec(name="s", horizon_s=300.0,
                                     engine="torch-stream",
                                     source=ListSource(wl))
    with pytest.raises(ValueError, match="single-replica"):
        experiment.run_experiment(spec.with_(n_replicas=3), device="cpu")
    with pytest.raises(ValueError, match="reliability"):
        experiment.run_experiment(spec.with_(
            reliability=ReliabilitySpec(time_quantum_s=1.0)), device="cpu")


def test_torch_stream_engine_synthesizes_without_source(params):
    spec = experiment.ExperimentSpec(name="s", horizon_s=1800.0,
                                     engine="torch-stream", seed=4)
    res = experiment.run_experiment(spec, params, device="cpu")
    assert res.summary["n_tasks"] > 0
    assert res.summary["n_windows"] >= 1
    again = experiment.run_experiment(spec, params, device="cpu")
    assert_same_records(res.records, again.records)
