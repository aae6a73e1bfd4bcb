"""Capacity planning (paper §VI-A / Fig 11): sweep learning-cluster capacity
against the fitted workload and find the knee where queueing collapses —
with Monte-Carlo confidence intervals from the batched engine on the card.

The ``"capacity:<resource>"`` sweep axis resizes one pool of the platform
(works for any resource count); with ``engine="torch"`` the whole grid —
five capacities x four replicas each — runs as ONE ``simulate_ensemble``
call.

  PYTHONPATH=src python examples/torch/capacity_planning.py [--device cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, fitted_params  # noqa: E402
from repro_torch.core.experiment import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

HORIZON = 43200.0
CAPACITIES = (4, 8, 16, 32, 64)


def main(device=None, horizon_s: float = HORIZON, n_replicas: int = 4,
         capacities=CAPACITIES, workload=None):
    """One row per capacity: its mean learning-cluster utilization, mean
    and p95 wait and the wait's 95 % CI half-width. ``workload`` pins the
    workload of every replica (then no fit is needed)."""
    dev = resolve_device(device)
    params = fitted_params(dev) if workload is None else None
    base = ExperimentSpec(name="cap", horizon_s=horizon_s, engine="torch",
                          n_replicas=n_replicas, seed=7, workload=workload)
    results = Sweep(base, {"capacity:learning_cluster": list(capacities)}
                    ).run(params, device=dev)

    print(f"{'capacity':>9} {'util':>6} {'mean wait s':>12} "
          f"{'p95 wait s':>11} {'ci95':>8}")
    rows = []
    for cap, res in zip(capacities, results):
        s = res.summary
        util = float(np.mean([r["utilization"]["learning_cluster"]
                              for r in res.replica_summaries]))
        rows.append({"capacity": int(cap), "util": util,
                     "mean_wait_s": s["mean_wait_s"],
                     "p95_wait_s": s["p95_wait_s"],
                     "ci95": s["wait_ci95_halfwidth"]})
        print(f"{cap:9d} {util:6.2f} {s['mean_wait_s']:12.1f} "
              f"{s['p95_wait_s']:11.1f} {s['wait_ci95_halfwidth']:8.2f}")

    print("\nPick the smallest capacity whose p95 wait meets the SLA — the "
          "simulated knee is where utilization crosses ~0.85.")
    return rows


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
