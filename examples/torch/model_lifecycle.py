"""Model lifecycle experiments (paper Fig 7) — the run-time view as a
first-class experiment: a fleet of deployed models drifts, drift triggers
fire retraining pipelines through the platform, completed deployments
restore performance. The whole loop runs INSIDE the engines' wave loop, so
a trigger-policy grid (drift thresholds x cooldowns) is ONE
``simulate_ensemble`` call on the card — and traces out the
**cost-vs-staleness frontier**: aggressive triggers buy fresh models with
retraining compute, lazy triggers save compute and eat staleness.

  PYTHONPATH=src python examples/torch/model_lifecycle.py [--device cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, fitted_params  # noqa: E402
from repro_torch.core.experiment import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.core.runtime import FleetSpec, TriggerSpec  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

HORIZON = 86400.0
THRESHOLDS = (0.02, 0.04, 0.08, 0.16)
COOLDOWNS = (2 * 3600.0, 8 * 3600.0)


def main(device=None, horizon_s: float = HORIZON, workload=None,
         fleet=None, retrain_durations=None):
    """One row per trigger policy (retrains, retrain node-hours, mean
    staleness, final mean performance), the non-dominated frontier, and
    the lifecycle timeline of point 5. ``workload`` pins the workload;
    ``fleet`` replaces the 8 sampled models (a ``FleetSpec``) and
    ``retrain_durations`` pins the retraining tasks' durations (with both
    pinned no fit is needed)."""
    dev = resolve_device(device)
    pinned = workload is not None and retrain_durations is not None
    params = None if pinned else fitted_params(dev)
    base = ExperimentSpec(
        name="lifecycle",
        horizon_s=horizon_s,
        seed=7,
        engine="torch",
        workload=workload,
        # accelerated aging so a 1-day horizon sees the whole loop many times
        fleet=fleet if fleet is not None
        else FleetSpec(n_models=8, drift_scale=60.0),
        trigger=TriggerSpec(interval_s=3600.0, obs_noise=0.005,
                            cooldown_s=4 * 3600.0,
                            retrain_durations=retrain_durations),
    )

    # the lifecycle-policy grid: every point is a (threshold, cooldown)
    # trigger policy over the same drifting fleet — ONE simulate_ensemble
    # call
    results = Sweep(base, {
        "trigger:drift_threshold": list(THRESHOLDS),
        "trigger:cooldown_s": list(COOLDOWNS),
    }).run(params, device=dev)

    print(f"{'policy':<46}{'retrains':>9}{'retrain nh':>11}"
          f"{'mean stale':>11}{'final perf':>11}")
    rows, frontier = [], []
    for r in results:
        lc = r.summary["lifecycle"]
        label = r.experiment.name.split("/", 1)[-1]
        nh = lc["retrain_node_seconds"] / 3600.0
        rows.append({"policy": label, "n_retrained": int(lc["n_retrained"]),
                     "retrain_node_hours": nh,
                     "mean_staleness": lc["mean_staleness"],
                     "final_mean_performance": lc["final_mean_performance"]})
        print(f"{label:<46}{lc['n_retrained']:>9d}{nh:>11.2f}"
              f"{lc['mean_staleness']:>11.4f}"
              f"{lc['final_mean_performance']:>11.4f}")
        frontier.append((nh, lc["mean_staleness"], label))

    # the frontier: policies no other policy beats on BOTH axes
    frontier.sort()
    print("\ncost-vs-staleness frontier (non-dominated trigger policies):")
    best, front = np.inf, []
    for nh, stale, label in frontier:
        if stale < best:
            best = stale
            front.append({"retrain_node_hours": nh, "mean_staleness": stale,
                          "policy": label})
            print(f"  {nh:8.2f} retrain node-hours -> mean staleness "
                  f"{stale:.4f}   [{label}]")

    # drill into one run: the engine-recorded lifecycle action timeline
    one = results[5]
    drill = None
    if one.lifecycle is not None:
        lc = one.lifecycle
        drill = {"n_triggered": int(lc.n_triggered),
                 "n_retrained": int(lc.n_retrained),
                 "redeploys": [(float(t), int(m)) for t, m in
                               zip(lc.redeploy_times, lc.redeploy_models)]}
        print(f"\n{one.experiment.name}: {lc.n_triggered} triggers, "
              f"{lc.n_retrained} redeploys over "
              f"{horizon_s / 86400.0:.0f} day(s)")
        for t, m in drill["redeploys"][:5]:
            print(f"  t={t / 3600.0:7.1f}h  model {m:2d} redeployed")
    return {"rows": rows, "frontier": front, "drill": drill}


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
