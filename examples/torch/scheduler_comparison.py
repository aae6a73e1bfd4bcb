"""Operational strategies (paper §III-B): compare admission policies on the
same congested workload — FIFO vs SJF vs staleness-priority.

Priority scheduling uses the run-time view: each pipeline retrains a
deployed model whose staleness determines its priority ("optimize the
potential improvement of all automated AI pipelines").

  PYTHONPATH=src python examples/torch/scheduler_comparison.py [--device cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, fitted_params, generator  # noqa: E402
from repro_torch.core import des  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.runtime import make_model_fleet  # noqa: E402
from repro_torch.core.synthesizer import synthesize_workload  # noqa: E402
from repro_torch.core.trace import flatten_trace  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

HORIZON = 86400.0
POLICIES = ((des.POLICY_FIFO, "fifo"), (des.POLICY_SJF, "sjf"),
            (des.POLICY_PRIORITY, "staleness"))


def platform():
    return M.PlatformConfig(resources=(
        M.ResourceConfig("compute_cluster", 16),
        M.ResourceConfig("learning_cluster", 6)))


def main(device=None, horizon_s: float = HORIZON, workload=None):
    """One row per policy: mean and p95 task wait and the
    staleness-weighted pipeline wait. ``workload`` pins the workload (its
    priorities are overwritten with the fleet's staleness)."""
    dev = resolve_device(device)
    plat = platform()
    wl = workload if workload is not None else synthesize_workload(
        fitted_params(dev), generator(dev, 3), horizon_s=horizon_s,
        platform=plat)

    # attach a drifting model to each pipeline; priority = potential
    # improvement
    rng = np.random.default_rng(0)
    fleet = make_model_fleet(rng, wl.n)
    staleness = np.array([m.potential_improvement(7 * 86400.0, 0.3)
                          for m in fleet], np.float32)
    wl.priority = staleness

    print(f"{'policy':>10} {'mean wait':>10} {'p95 wait':>10} "
          f"{'stale-weighted wait':>20}")
    rows = []
    for policy, name in POLICIES:
        tr = des.simulate(wl, plat, policy)
        rec = flatten_trace(tr, wl)
        pipe_wait = np.zeros(wl.n)
        np.add.at(pipe_wait, rec.pipeline, rec.wait)
        weighted = float((pipe_wait * staleness).sum() / staleness.sum())
        rows.append({"policy": name, "mean_wait_s": float(rec.wait.mean()),
                     "p95_wait_s": float(np.percentile(rec.wait, 95)),
                     "stale_weighted_wait_s": weighted})
        print(f"{name:>10} {rec.wait.mean():10.1f} "
              f"{np.percentile(rec.wait, 95):10.1f} {weighted:20.1f}")

    print("\nStaleness-priority minimizes the staleness-weighted wait — the "
          "paper's 'overall potential improvement' objective — at a modest "
          "mean-wait cost vs SJF.")
    return rows


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
