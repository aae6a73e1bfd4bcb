"""The port's span export (``repro_torch.obs.spans``) and span replay
(``repro_torch.stream.SpanSource``) against the JAX package, on the CPU.

Spans built from the same records (and the same run's action timeline)
must write a JSONL file **byte for byte** the reference's, and a Chrome
trace equal to the reference's; chunked appends give the same bytes as one
write. Exporting a port run with retries, reading the file back into a
``SpanSource`` and re-simulating it (one-shot and windowed) must give back
every attempt interval exactly (integer times, no resampling, the original
backoff), and the reconstructed workload and replay scenario equal the
reference's ``SpanSource`` on the same file. Latent retraining-pool rows
whose trigger never fired appear in no span.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import model as RM
from repro.core import trace as ref_trace
from repro.obs import spans as ref_spans
from repro.stream import SpanSource as RefSpanSource
from repro_torch import stream
from repro_torch.core import experiment, runtime
from repro_torch.core import model as M
from repro_torch.obs import spans
from repro_torch.ops import capacity, failures, scenario
from test_compaction import TRIG, fleet_tensor
from test_des_engines import make_workload, platform


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_platform():
    return M.PlatformConfig(resources=tuple(
        M.ResourceConfig(r.name, r.capacity, r.cost_per_node_hour)
        for r in platform().resources))


def port_workload(w):
    return M.Workload(**{f.name: getattr(w, f.name)
                         for f in dataclasses.fields(w)})


RETRY = dict(max_retries=2, base_s=4.0, mult=2.0, cap_s=16.0)


@pytest.fixture(scope="module")
def run():
    """A port run with retries (per-attempt records) and a closed-loop
    controller (action events on the root span)."""
    wl = make_workload(np.random.default_rng(20260814), 40,
                       integer_time=True, horizon=400.0)
    sc = scenario.Scenario(
        name="f", failures=failures.FailureModel(
            p_fail_by_type=(0.35,) * 6,
            retry=failures.RetryPolicy(**RETRY), resample_service=False),
        controller=capacity.ReactiveController(
            high_watermark=0.3, step=0.5, max_scale=4.0, interval_s=50.0))
    spec = experiment.ExperimentSpec(
        name="orig", platform=port_platform(), horizon_s=500.0,
        workload=port_workload(wl), scenario=sc)
    res = experiment.run_experiment(spec, device="cpu")
    from repro_torch.core import vdes
    comp = sc.compile(spec.workload, spec.platform, 500.0, seed=0)
    tr = vdes.simulate_to_trace(spec.workload, spec.platform, scenario=comp,
                                device="cpu")
    assert res.records.att_start is not None
    assert (np.asarray(res.records.attempts) > 1).any()
    assert tr.ctrl_times is not None and len(tr.ctrl_times) > 0
    return res, tr, sc


def ref_records(rec):
    return ref_trace.TaskRecords(**{f.name: getattr(rec, f.name)
                                    for f in dataclasses.fields(rec)})


def ref_sim_trace(tr):
    return RM.SimTrace(**{f.name: getattr(tr, f.name)
                          for f in dataclasses.fields(tr)})


def test_jsonl_byte_identical_to_reference(run, tmp_path):
    res, tr, _ = run
    got = spans.build_spans(res.records, tr, name="orig")
    want = ref_spans.build_spans(ref_records(res.records), ref_sim_trace(tr),
                                 name="orig")
    assert got == want
    assert any(s["kind"] == "attempt" for s in got)
    assert got[0]["events"], "no controller action on the root span"
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    spans.write_spans_jsonl(got, a)
    ref_spans.write_spans_jsonl(want, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert spans.read_spans_jsonl(a) == ref_spans.read_spans_jsonl(b) == got


def test_jsonl_append_byte_identical(run, tmp_path):
    """N appended chunks make the file one write makes."""
    got = spans.build_spans(run[0].records)
    one, chunks = str(tmp_path / "one.jsonl"), str(tmp_path / "chk.jsonl")
    spans.write_spans_jsonl(got, one)
    for i in range(0, len(got), 5):
        spans.write_spans_jsonl(got[i:i + 5], chunks, append=i > 0)
    assert open(one, "rb").read() == open(chunks, "rb").read()
    assert spans.read_spans_jsonl(chunks) == got


def test_chrome_trace_equal_to_reference(run, tmp_path):
    res, tr, _ = run
    got = spans.build_spans(res.records, tr)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    spans.write_chrome_trace(got, a)
    ref_spans.write_chrome_trace(got, b)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)
    assert spans.read_chrome_attempt_intervals(a) \
        == ref_spans.read_chrome_attempt_intervals(b) \
        == spans.attempt_intervals(got)
    assert spans.attempt_intervals(got) \
        == spans.attempt_intervals_from_records(res.records) \
        == ref_spans.attempt_intervals_from_records(ref_records(res.records))


@pytest.mark.parametrize("n_windows", [1, 2, 5])
def test_span_replay_exact(run, tmp_path, n_windows):
    """Export -> chunked JSONL -> SpanSource -> re-simulate gives back every
    attempt interval exactly, one-shot and windowed, and the source's
    workload and replay scenario equal the reference's on the same file."""
    res, _, sc = run
    got = spans.build_spans(res.records, name="orig")
    path = str(tmp_path / "spans.jsonl")
    cut = len(got) // 2
    spans.write_spans_jsonl(got[:cut], path)
    spans.write_spans_jsonl(got[cut:], path, append=True)

    plat = port_platform()
    src = stream.SpanSource(path, platform=plat)
    ref_src = RefSpanSource(path, platform=platform())
    assert src.n_approximate == ref_src.n_approximate == 0
    for f in dataclasses.fields(src.workload):
        np.testing.assert_array_equal(getattr(src.workload, f.name),
                                      getattr(ref_src.workload, f.name),
                                      err_msg=f.name)
    np.testing.assert_array_equal(src.pipeline_ids, ref_src.pipeline_ids)
    # the original run's retry backoff and controller (compiled against
    # the same platform and horizon) make the replay exact
    backoff = sc.failures.retry.backoff
    replay = src.scenario(backoff=backoff, controller=sc.controller,
                          horizon_s=500.0)
    ref_replay = ref_src.scenario(backoff=backoff,
                                  controller=replay.controller)
    np.testing.assert_array_equal(replay.controller, ref_replay.controller)
    np.testing.assert_array_equal(replay.attempts, ref_replay.attempts)
    assert (replay.attempt_service is None) \
        == (ref_replay.attempt_service is None)

    one = stream.oneshot_reference(src, plat, scenario=replay,
                                   horizon_s=500.0, device="cpu")
    back = spans.attempt_intervals_from_records(
        src.remap_pipelines(one["records"]))
    assert back == spans.attempt_intervals(got)
    sr = stream.stream_simulate(src, plat, scenario=replay, horizon_s=500.0,
                                window_s=500.0 / n_windows, min_rows=16,
                                device="cpu")
    assert stream.parity_drift(sr, one) == 0.0


def test_latent_pool_rows_have_no_spans():
    """A fleet run whose trigger fires for some slots only: the spans hold
    the exogenous pipelines and the activated retraining pipelines, and no
    latent pool row."""
    wl = port_workload(make_workload(np.random.default_rng(20260807), 50,
                                     integer_time=True, horizon=300.0))
    trig = runtime.TriggerSpec(**{f.name: getattr(TRIG, f.name)
                                  for f in dataclasses.fields(TRIG)})
    fleet = runtime.FleetSpec(params=fleet_tensor())
    res = experiment.run_experiment(experiment.ExperimentSpec(
        name="fl", platform=port_platform(), horizon_s=300.0, workload=wl,
        fleet=fleet, trigger=trig), device="cpu")
    P = scenario.compile_fleet(fleet, trig, wl, port_platform(),
                               300.0)[0].n_pool
    n_fired = res.lifecycle.n_triggered
    assert 0 < n_fired < P
    got = spans.build_spans(res.records)
    pids = {s["attributes"]["pipeline"] for s in got
            if s["kind"] == "pipeline"}
    assert len(pids) == wl.n + n_fired
    assert set(range(wl.n)) <= pids
    assert max(pids) < wl.n + P
