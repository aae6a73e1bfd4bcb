"""The in-simulation telemetry plane, end to end: probe a closed-loop
lifecycle experiment, read the named channel timelines, and export the run
as an OTel-style span tree you can open in a real trace viewer.

One ``ProbeSpec`` on the experiment turns on in-loop sampling: both engines
record queue depth, busy slots, effective capacity, controller delta, and
fleet perf/staleness at a fixed tick grid — inside the simulation loop, with
bit-identical buffers on the heap engine and the card's. The span export
turns the same run's task records + engine-recorded actions into
``build/examples/observability_trace.json`` — drag it onto
https://ui.perfetto.dev (or ``chrome://tracing``) to scrub through the
simulated platform like a production trace.

  PYTHONPATH=src python examples/torch/observability.py [--device cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import OUT_DIR, arg_parser, fitted_params  # noqa: E402
from repro_torch.core.experiment import (ExperimentSpec,  # noqa: E402
                                         run_experiment)
from repro_torch.core.runtime import FleetSpec, TriggerSpec  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.obs import (ProbeSpec, build_spans,  # noqa: E402
                             write_chrome_trace, write_spans_jsonl)
from repro_torch.ops import ReactiveController  # noqa: E402

HORIZON = 86400.0
CHANNELS = ("qlen:compute_cluster", "busy:compute_cluster",
            "cap:compute_cluster", "ctrl_delta:compute_cluster",
            "fleet_min_perf", "fleet_max_staleness")


def spec(horizon_s: float = HORIZON, workload=None, fleet=None,
         retrain_durations=None) -> ExperimentSpec:
    """The probed closed-loop lifecycle experiment on the heap engine."""
    return ExperimentSpec(
        name="observability",
        horizon_s=horizon_s,
        seed=3,
        engine="numpy",
        workload=workload,
        fleet=fleet if fleet is not None
        else FleetSpec(n_models=6, drift_scale=60.0),
        trigger=TriggerSpec(interval_s=3600.0, obs_noise=0.005,
                            cooldown_s=4 * 3600.0, drift_threshold=0.06,
                            retrain_durations=retrain_durations),
        probe=ProbeSpec(interval_s=1800.0),        # sample every 30 min
    ).with_(controller=ReactiveController(high_watermark=0.3, step=0.5,
                                          max_scale=3.0, interval_s=3600.0))


def main(device=None, horizon_s: float = HORIZON, workload=None,
         fleet=None, retrain_durations=None, out_dir=OUT_DIR):
    """Returns the probe's sampled rows (every 4th sampled tick, as
    printed), the span kinds' counts and the two files written under
    ``out_dir``. ``workload``, ``fleet`` and ``retrain_durations`` pin the
    spec's parts (with the workload and the durations pinned no fit is
    needed)."""
    dev = resolve_device(device)
    pinned = workload is not None and retrain_durations is not None
    params = None if pinned else fitted_params(dev)
    res = run_experiment(spec(horizon_s, workload, fleet, retrain_durations),
                         params, device=dev)

    # --- 1. the probe timeline: named channels at the probe's tick grid
    tl = res.timeline
    s = tl.sampled
    print(f"probe: {int(s.sum())}/{tl.times.shape[0]} ticks sampled, "
          f"channels = {list(tl.channels)}\n")
    print(f"{'t [h]':>7} {'qlen:cc':>8} {'busy:cc':>8} {'cap:cc':>7} "
          f"{'delta:cc':>9} {'min perf':>9} {'max stale[h]':>13}")
    rows = []
    for i in np.nonzero(s)[0][::4]:
        row = {"t_h": float(tl.times[i] / 3600.0)}
        row.update({c: float(tl.channel(c)[i]) for c in CHANNELS})
        rows.append(row)
        print(f"{row['t_h']:>7.1f} "
              f"{row['qlen:compute_cluster']:>8.0f} "
              f"{row['busy:compute_cluster']:>8.0f} "
              f"{row['cap:compute_cluster']:>7.0f} "
              f"{row['ctrl_delta:compute_cluster']:>9.0f} "
              f"{row['fleet_min_perf']:>9.4f} "
              f"{row['fleet_max_staleness'] / 3600.0:>13.2f}")

    # --- 2. span export: the run as a distributed-tracing tree
    spans = build_spans(res.records, name="observability")
    kinds = {}
    for sp in spans:
        kinds[sp["kind"]] = kinds.get(sp["kind"], 0) + 1
    print(f"\nspan tree: {kinds}")

    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "observability_spans.jsonl")
    chrome = os.path.join(out_dir, "observability_trace.json")
    write_spans_jsonl(spans, jsonl)
    write_chrome_trace(spans, chrome)
    print(f"wrote {jsonl}")
    print(f"wrote {chrome}")
    print("open the trace: https://ui.perfetto.dev  (or chrome://tracing) "
          "and load observability_trace.json")
    return {"ticks_sampled": int(s.sum()), "ticks": int(tl.times.shape[0]),
            "channels": list(tl.channels), "rows": rows, "span_kinds": kinds,
            "files": [jsonl, chrome]}


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
