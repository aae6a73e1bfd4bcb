"""Availability-vs-cost frontier under correlated failures (AIReSim-style):
sweep the spot-pool share against repair-crew capacity and read the
trade-off straight out of each point's ``availability`` summary block.

A bigger spot pool is cheaper (``discount`` x on-demand) but loses more
capacity to mass evictions; more repair crews return failed domains
faster (capacity comes back at the crew's FIFO *finish* time, never
instantaneously) but add standing cost you can price however you like.
The ``"reliability:*"`` sweep axes batch like every other axis — the
whole 4 x 3 grid below is ONE ``simulate_ensemble`` call on the card,
reliability-free points riding the same batch via never-firing padding
rows.

  PYTHONPATH=src python examples/torch/reliability_frontier.py [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, fitted_params  # noqa: E402
from repro_torch.core.experiment import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.reliability import (DomainOutageModel,  # noqa: E402
                                     ReliabilitySpec, RepairSpec,
                                     SpotPoolSpec, TopologySpec)

HORIZON = 43200.0


def grid(horizon_s: float = HORIZON):
    """The base reliability spec and the spot x crew axes, every time
    relative to the horizon."""
    rel = ReliabilitySpec(
        topology=TopologySpec(zones=2, racks_per_zone=4),
        outages=DomainOutageModel(zone_mtbf_s=horizon_s / 2.0,
                                  rack_mtbf_s=horizon_s / 4.0,
                                  mttr_s=horizon_s / 24.0),
        time_quantum_s=1.0)
    spots = [None] + [SpotPoolSpec(frac=f, evict_mtbe_s=horizon_s / 3.0,
                                   reclaim_s=horizon_s / 48.0)
                      for f in (0.2, 0.4, 0.6)]
    crews = [RepairSpec(crews=c, repair_time_s=horizon_s / 24.0)
             for c in (1, 2, 6)]
    return rel, spots, crews


def main(device=None, horizon_s: float = HORIZON, workload=None):
    """One row per (spot share, crews) point: the worst resource's
    availability, cost, spot savings, the longest repair wait and the
    evicted tasks. ``workload`` pins the workload (then no fit is
    needed)."""
    dev = resolve_device(device)
    params = fitted_params(dev) if workload is None else None
    rel, spots, crews = grid(horizon_s)
    base = ExperimentSpec(name="frontier", horizon_s=horizon_s,
                          engine="torch", seed=7, workload=workload,
                          reliability=rel)
    results = Sweep(base, {"reliability:spot": spots,
                           "reliability:repair": crews}).run(params,
                                                             device=dev)

    print(f"{'spot frac':>9} {'crews':>5} {'avail':>7} {'cost':>10} "
          f"{'savings':>9} {'max wait s':>10} {'evicted':>7}")
    rows = []
    for (spot, crew), res in zip(((s, c) for s in spots for c in crews),
                                 results):
        a = res.summary["availability"]
        cost = a["cost_split"]["on_demand_cost"] + a["cost_split"]["spot_cost"]
        row = {"spot_frac": spot.frac if spot else 0.0, "crews": crew.crews,
               "availability": min(a["availability"].values()),
               "cost": cost, "spot_savings": a["cost_split"]["spot_savings"],
               "max_repair_wait_s": a["repair"]["max_wait_s"],
               "evicted_tasks": (a["eviction"]["evicted_tasks"]
                                 if "eviction" in a else 0)}
        rows.append(row)
        print(f"{row['spot_frac']:9.1f} {crew.crews:5d} "
              f"{row['availability']:7.3f} {cost:10.0f} "
              f"{row['spot_savings']:9.0f} "
              f"{row['max_repair_wait_s']:10.0f} "
              f"{row['evicted_tasks']:7d}")

    print("\nThe frontier: walk down the cost column until availability "
          "drops below your SLO; adding crews buys back availability at the "
          "saturated (1-crew) points where max repair wait explodes.")
    return rows


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
