"""PipeSim experiment launcher (mirrors :mod:`repro.launch.simulate`, the
paper's CLI entry point).

Fits simulation parameters from (generated) empirical traces on the device,
synthesizes the replicas' workloads there, simulates them as one ensemble
and prints the analytics summary as JSON:

  PYTHONPATH=src python -m repro_torch.launch.simulate --days 2 \
      --horizon-days 1 --learning-capacity 8 --policy sjf

``--device`` defaults to the card (``cpu`` runs everything on the CPU).
``--engine`` picks the batched ``torch`` engine (the default) or the
``numpy`` heap engine, which simulates on the host while the fit and the
synthesis still run on ``--device`` (the reference's default is
``numpy``). ``--params-cache`` reads an ``.npz`` written by either package (the
layouts are the same) and, when the file does not exist, writes the fit
there; without it every run fits anew.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import model as M
from repro_torch.core.des import POLICY_NAMES
from repro_torch.core.experiment import ExperimentSpec, run_experiment
from repro_torch.core.fitting import SimulationParams, fit_simulation_params
from repro_torch.core.workload import generate_empirical_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=2.0,
                    help="days of empirical traces to fit on")
    ap.add_argument("--horizon-days", type=float, default=1.0)
    ap.add_argument("--interarrival-factor", type=float, default=1.0)
    ap.add_argument("--compute-capacity", type=int, default=48)
    ap.add_argument("--learning-capacity", type=int, default=32)
    ap.add_argument("--policy", default="fifo", choices=POLICY_NAMES)
    ap.add_argument("--engine", default="torch", choices=["torch", "numpy"])
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params-cache", default=None,
                    help=".npz of fitted parameters (either package's); "
                         "written after a fit when it does not exist")
    ap.add_argument("--device", default="cuda",
                    help="where to fit and simulate (default: the card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.params_cache and os.path.exists(args.params_cache):
        params = SimulationParams.load(args.params_cache, device=args.device)
        print(f"[params] loaded {args.params_cache}")
    else:
        print(f"[fit] generating {args.days} days of empirical traces ...")
        wl = generate_empirical_workload(seed=123,
                                         horizon_s=args.days * 86400.0)
        print(f"[fit] fitting on {wl.n} pipelines ...")
        params = fit_simulation_params(wl, device=args.device)
        if args.params_cache:
            params.save(args.params_cache)

    exp = ExperimentSpec(
        name="cli",
        platform=M.PlatformConfig(resources=(
            M.ResourceConfig("compute_cluster", args.compute_capacity),
            M.ResourceConfig("learning_cluster", args.learning_capacity, 3.0),
        )),
        horizon_s=args.horizon_days * 86400.0,
        interarrival_factor=args.interarrival_factor,
        policy=POLICY_NAMES.index(args.policy),
        seed=args.seed,
        n_replicas=args.replicas,
        engine=args.engine,
    )
    res = run_experiment(exp, params, device=args.device)
    print(json.dumps(res.summary, indent=2, default=float))
    if args.out:
        res.save(args.out)
        print(f"[saved] {args.out}")


if __name__ == "__main__":
    main()
