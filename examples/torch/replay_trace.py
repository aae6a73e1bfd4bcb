"""Trace-driven replay, end to end: export a run as spans, rebuild the
workload from the span file alone, replay it bit-exactly, then answer a
what-if against the *same observed demand*.

Exact replay holds on the integer-time configuration with
``resample_service=False`` (service is a pure function of the task, so
re-simulating reproduces every attempt window to the float32 ulp). The
spans are the only thing that crosses the boundary: the replay side never
sees the original ``Workload`` — :class:`repro_torch.stream.SpanSource`
derives arrivals, service times, task types, and per-attempt retry counts
from the JSONL file that a real platform's tracing pipeline would emit.
Every run here is the batched engine on the card, one-shot or streamed in
windows.

  PYTHONPATH=src python examples/torch/replay_trace.py [--device cpu]
"""
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import OUT_DIR, arg_parser, fitted_params, generator  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.synthesizer import synthesize_workload  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.obs import (attempt_intervals,  # noqa: E402
                             attempt_intervals_from_records, build_spans,
                             write_spans_jsonl)
from repro_torch.ops import (FailureModel, ReactiveController,  # noqa: E402
                             RetryPolicy, Scenario, static_schedule)
from repro_torch.stream import (SpanSource, oneshot_reference,  # noqa: E402
                                parity_drift, stream_simulate)

HORIZON = 0.25 * 86400.0
WHATIF_KEYS = ("mean_wait_s", "p95_wait_s", "p99_wait_s")


class BlockSource:
    """A pinned workload served as arrival-ordered blocks (a TraceSource)."""

    name = "replay-example"

    def __init__(self, wl, block=64):
        self.wl, self.block = wl, block

    def blocks(self):
        for lo in range(0, self.wl.arrival.shape[0], self.block):
            hi = min(lo + self.block, self.wl.arrival.shape[0])
            yield M.Workload(**{
                f.name: (v[lo:hi] if isinstance(
                    v := getattr(self.wl, f.name), np.ndarray) else v)
                for f in dataclasses.fields(M.Workload)})


def main(device=None, horizon_s: float = HORIZON, out_dir=OUT_DIR):
    """Returns the original run's size and waits, the span export's and
    the replay's counts, the replay's largest attempt-interval error, the
    windowed replay's parity drift and the what-if table."""
    dev = resolve_device(device)
    span_path = os.path.join(out_dir, "replay_spans.jsonl")
    os.makedirs(out_dir, exist_ok=True)

    # --- 1. the "production" run we will later replay from its trace ------
    wl = synthesize_workload(fitted_params(dev), generator(dev, 31),
                             horizon_s)
    wl.arrival = np.floor(wl.arrival)      # integer-time config: exactness
    wl.exec_time = np.ceil(wl.exec_time)
    wl.read_bytes[:] = 0.0
    wl.write_bytes[:] = 0.0

    scenario = Scenario(
        name="prod",
        failures=FailureModel(
            p_fail_by_type=(0.3,) * M.N_TASK_TYPES,
            retry=RetryPolicy(max_retries=2, base_s=30.0, mult=2.0,
                              cap_s=240.0),
            resample_service=False))
    backoff = scenario.failures.retry.backoff

    orig = oneshot_reference(BlockSource(wl), scenario=scenario,
                             horizon_s=horizon_s, seed=17, device=dev)
    print(f"original run: {wl.n} pipelines, "
          f"mean wait {orig['summary']['mean_wait_s']:.1f}s, "
          f"p95 wait {orig['summary']['p95_wait_s']:.1f}s")

    # --- 2. export the run as spans — the trace a real platform would keep
    spans = build_spans(orig["records"], name="replay-example")
    cut = len(spans) // 3                  # append=True: chunked export
    write_spans_jsonl(spans[:cut], span_path)
    write_spans_jsonl(spans[cut:], span_path, append=True)
    print(f"exported {len(spans)} spans -> {span_path}")

    # --- 3. rebuild the workload from the file alone and replay it exactly
    rsrc = SpanSource(span_path)
    rscn = rsrc.scenario(backoff=backoff)
    print(f"SpanSource: {rsrc.pipeline_ids.shape[0]} pipelines recovered, "
          f"{rsrc.n_approximate} approximate rows")

    replay = oneshot_reference(rsrc, scenario=rscn, horizon_s=horizon_s,
                               device=dev)
    got = attempt_intervals_from_records(
        rsrc.remap_pipelines(replay["records"]))
    want = attempt_intervals(spans)
    err = max(max(abs(a0 - b0), abs(a1 - b1))
              for (a0, a1), (b0, b1) in ((got[k], want[k]) for k in want))
    print(f"exact replay: {len(want)} attempt intervals, "
          f"max |observed - replayed| = {err}")

    # windowed replay is bit-identical to the one-shot replay, too
    streamed = stream_simulate(rsrc, scenario=rscn, horizon_s=horizon_s,
                               window_s=horizon_s / 4, device=dev)
    drift = parity_drift(streamed, replay)
    print(f"windowed replay ({streamed.n_windows} windows): "
          f"parity drift vs one-shot = {drift}\n")

    # --- 4. what-if: same observed demand, different operating point ------
    # The demand (arrivals, services, observed attempt counts) is pinned by
    # the trace; schedule and controller are the exchangeable knobs on
    # ``SpanSource.scenario``. Here: a quarter of the capacity, with a
    # reactive autoscaler allowed to claw some of it back under pressure.
    lean_caps = np.maximum(1, np.asarray(rsrc.platform.capacities) // 4)
    whatif_scn = rsrc.scenario(
        backoff=backoff, schedule=static_schedule(lean_caps),
        controller=ReactiveController(high_watermark=0.2, step=0.5,
                                      max_scale=3.0, interval_s=1800.0),
        horizon_s=horizon_s)
    whatif = stream_simulate(rsrc, scenario=whatif_scn, horizon_s=horizon_s,
                             window_s=horizon_s / 4, device=dev)

    base, alt = replay["summary"], whatif.summary
    print("what-if on the replayed trace: quarter capacity + autoscaler")
    print(f"{'':>24} {'replayed':>10} {'what-if':>10}")
    for key in WHATIF_KEYS:
        print(f"{key:>24} {base[key]:>10.1f} {alt[key]:>10.1f}")
    n_ctrl = 0 if whatif.ctrl_times is None else len(whatif.ctrl_times)
    print(f"controller actions taken: {n_ctrl}")
    return {"pipelines": int(wl.n),
            "orig_mean_wait_s": orig["summary"]["mean_wait_s"],
            "orig_p95_wait_s": orig["summary"]["p95_wait_s"],
            "spans": len(spans),
            "recovered_pipelines": int(rsrc.pipeline_ids.shape[0]),
            "approximate_rows": int(rsrc.n_approximate),
            "attempt_intervals": len(want), "replay_max_err": float(err),
            "windows": int(streamed.n_windows), "parity_drift": drift,
            "replayed": {k: base[k] for k in WHATIF_KEYS},
            "whatif": {k: alt[k] for k in WHATIF_KEYS},
            "controller_actions": n_ctrl}


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
