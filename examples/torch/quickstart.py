"""Quickstart: the PipeSim loop on PyTorch in ~60 lines.

1. Generate empirical platform traces (the "real system");
2. fit simulation parameters (GMMs on the card, duration curves,
   clustered arrivals);
3. synthesize a workload and simulate it on a modeled platform;
4. read the analytics.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, generator  # noqa: E402
from repro_torch.core import (PlatformConfig, ResourceConfig, des,  # noqa: E402
                              fit_simulation_params,
                              generate_empirical_workload,
                              synthesize_workload)
from repro_torch.core.trace import flatten_trace, summarize  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

TRACE_DAYS = 2.0
HORIZON = 86400.0


def main(device=None, days: float = TRACE_DAYS, horizon_s: float = HORIZON,
         em_iters: int = 30):
    """Returns the empirical traces' size and mean interarrival and the
    simulated day's summary."""
    dev = resolve_device(device)
    # 1. two days of "production" traces
    wl = generate_empirical_workload(seed=0, horizon_s=days * 86400.0)
    mean_ia = float(np.diff(np.sort(wl.arrival)).mean())
    print(f"empirical traces: {wl.n} pipelines, "
          f"mean interarrival {mean_ia:.1f}s")

    # 2. fit -> export (the paper's scipy/scikit-learn offline step; the
    # GMMs' EM on the device)
    params = fit_simulation_params(wl, interarrival_families=(0,),
                                   asset_components=16, em_iters=em_iters,
                                   max_cluster_fit_n=500, device=dev)

    # 3. simulate one day on a smaller platform than production
    platform = PlatformConfig(resources=(
        ResourceConfig("compute_cluster", 24),
        ResourceConfig("learning_cluster", 12)))
    syn = synthesize_workload(params, generator(dev, 1), horizon_s=horizon_s,
                              platform=platform)
    trace = des.simulate(syn, platform)

    # 4. analytics (the dashboard numbers)
    rec = flatten_trace(trace, syn)
    summary = summarize(rec, platform.capacities, horizon_s)
    print(json.dumps(summary, indent=2, default=float))
    return {"empirical_pipelines": int(wl.n),
            "mean_interarrival_s": mean_ia, "summary": summary}


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
