"""Operational scenario A/B: static capacity vs maintenance windows vs
predictive (hour-of-week) and reactive (queue-length) autoscalers, with
failure/retry injection and node outages — comparing p95 wait, deadline-miss
rate, and provisioned cost (the paper's "devise and evaluate operational
strategies", extended with AIReSim-style reliability).

Written against the declarative API: an :class:`ExperimentSpec` carries the
full platform (any number of resources, each with its own cost), and
``Sweep`` runs the scenario axis as one grid — serially on the exact heap
engine (``"numpy"``: synthesis on the device, simulation on the host) here;
switch the base to ``engine="torch"`` and the whole grid lowers to ONE
``simulate_ensemble`` call on the card.

  PYTHONPATH=src python examples/torch/autoscaling_scenarios.py [--device cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, fitted_params  # noqa: E402
from repro_torch.core.experiment import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.core.model import PlatformConfig, ResourceConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.ops import (FailureModel, MaintenanceWindows,  # noqa: E402
                             OutageModel, ReactiveAutoscaler, Scenario,
                             ScheduledAutoscaler, SLOConfig)

HORIZON = 86400.0


def scenarios():
    slo = SLOConfig(pipeline_deadline_s=4 * 3600.0, task_wait_slo_s=900.0)
    fails = FailureModel(resample_service=True)   # retries re-draw durations
    return [
        Scenario(name="static", slo=slo, failures=fails),
        Scenario(name="maintenance", slo=slo, failures=fails,
                 capacity=MaintenanceWindows(
                     windows=((2 * 3600.0, 6 * 3600.0, 1, 0.25),))),
        Scenario(name="outages", slo=slo, failures=fails,
                 outages=OutageModel(mtbf_s=8 * 3600.0, mttr_s=3600.0,
                                     frac_lost=0.33)),
        Scenario(name="predictive", slo=slo, failures=fails,
                 capacity=ScheduledAutoscaler(min_scale=0.4, max_scale=1.3)),
        Scenario(name="reactive", slo=slo, failures=fails,
                 capacity=ReactiveAutoscaler(interval_s=3600.0, max_scale=2.0,
                                             min_scale=0.4)),
    ]


def main(device=None, horizon_s: float = HORIZON, workload=None):
    """One row per scenario: p95 wait, deadline-miss and wait-SLO violation
    rates, provisioned cost and utilization of the provisioned capacity.
    ``workload`` pins the workload of every scenario (then no fit is
    needed)."""
    dev = resolve_device(device)
    params = fitted_params(dev) if workload is None else None
    base = ExperimentSpec(
        name="ops", horizon_s=horizon_s, seed=7, engine="numpy",
        workload=workload,
        platform=PlatformConfig(resources=(
            ResourceConfig("compute_cluster", 48, cost_per_node_hour=1.0),
            ResourceConfig("learning_cluster", 16, cost_per_node_hour=3.0),
        )))
    scs = scenarios()
    results = Sweep(base, {"scenario": scs}).run(params, device=dev)

    print(f"{'scenario':>12} {'p95 wait s':>11} {'miss rate':>10} "
          f"{'wait SLO viol':>13} {'cost $':>9} {'util(prov)':>10}")
    rows = []
    for sc, res in zip(scs, results):
        s = res.summary
        util = float(np.mean(list(s["utilization_vs_provisioned"].values())))
        rows.append({"scenario": sc.name, "p95_wait_s": s["p95_wait_s"],
                     "deadline_miss_rate": s["deadline_miss_rate"],
                     "wait_slo_violation_rate": s["wait_slo_violation_rate"],
                     "total_cost": s["total_cost"], "util_provisioned": util})
        print(f"{sc.name:>12} {s['p95_wait_s']:11.1f} "
              f"{s['deadline_miss_rate']:10.3f} "
              f"{s['wait_slo_violation_rate']:13.3f} {s['total_cost']:9.1f} "
              f"{util:10.2f}")

    print("\nThe autoscalers trade provisioned cost against wait/deadline "
          "SLOs; outages show the resilience margin. Cross this axis with "
          "capacities and schedulers — base.with_(engine='torch') runs the "
          "whole grid as one batched call on the card.")
    return rows


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
