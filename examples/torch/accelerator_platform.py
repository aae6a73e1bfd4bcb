"""The trace link: simulate an accelerator-cluster AI platform whose
training-task durations come from the ROOFLINE COST MODEL of the port's
LM stack counted on the H100 — PipeSim scheduling the very architectures
this repo trains.

Requires the one-card dry-run's cells (run ``PYTHONPATH=src python -m
repro_torch.launch.dryrun --all`` first; they land in
``artifacts/dryrun_torch/h100x1/``).

  PYTHONPATH=src python examples/torch/accelerator_platform.py [--device cpu]
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser, generator  # noqa: E402
from repro_torch.core import costmodel, des  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

N_STEPS = 2000
N_JOBS = 300
PODS = (2, 4, 8)


def main(device=None, root=None, n_jobs: int = N_JOBS):
    """The catalog's medians per arch, the retraining workload's columns
    and one row per pod count (mean and p95 queue wait). ``root`` is the
    dry-run's root (default: ``artifacts/``)."""
    dev = resolve_device(device)
    catalog = costmodel.accelerator_workload_catalog(n_steps=N_STEPS,
                                                     root=root)
    if not catalog:
        raise SystemExit("no dry-run artifacts found — run "
                         "repro_torch.launch.dryrun")
    catalog = {a: d.to(dev) for a, d in catalog.items()}

    print(f"roofline-grounded train-task medians ({N_STEPS} steps):")
    medians = {}
    for arch, dist in sorted(catalog.items()):
        medians[arch] = float(torch.median(
            dist.sample(generator(dev, 0), (2000,))).cpu())
        print(f"  {arch:28s} {medians[arch] / 3600.0:8.2f} h")

    # build a platform workload: retraining jobs for a fleet of these archs
    archs = sorted(catalog)
    rng = np.random.default_rng(1)
    arrival = np.sort(rng.uniform(0, 7 * 86400.0, n_jobs))
    pick = rng.integers(0, len(archs), n_jobs)
    gen = generator(dev, 2)
    dur = np.array([float(catalog[archs[p]].sample(gen, ()).cpu())
                    for p in pick])

    tt = np.full((n_jobs, 1), M.TRAIN, np.int32)
    cols = dict(
        arrival=arrival, n_tasks=np.ones(n_jobs, np.int32), task_type=tt,
        task_res=np.ones((n_jobs, 1), np.int32),  # learning cluster
        exec_time=dur[:, None], read_bytes=np.zeros((n_jobs, 1)),
        write_bytes=np.zeros((n_jobs, 1)), framework=pick.astype(np.int32),
        priority=np.zeros(n_jobs, np.float32),
        model_perf=np.zeros(n_jobs, np.float32),
        model_size=np.zeros(n_jobs, np.float32),
        model_clever=np.zeros(n_jobs, np.float32))
    wl = M.Workload(**cols)

    rows = []
    for n_pods in PODS:
        plat = M.PlatformConfig(resources=(
            M.ResourceConfig("compute", 1),
            M.ResourceConfig("tpu_pods", n_pods)))
        tr = des.simulate(wl, plat)
        wait = tr.wait[:, 0]
        rows.append({"pods": n_pods, "mean_wait_h": float(wait.mean() / 3600),
                     "p95_wait_h": float(np.percentile(wait, 95) / 3600)})
        print(f"pods={n_pods}: mean queue wait "
              f"{rows[-1]['mean_wait_h']:6.1f} h, "
              f"p95 {rows[-1]['p95_wait_h']:6.1f} h")

    print("\nThis is the paper's 'link to the real system': pod-count "
          "planning for retraining fleets, grounded in rooflines counted "
          "for the card.")
    return {"medians_s": medians, "workload": cols, "rows": rows}


if __name__ == "__main__":
    main(**vars(arg_parser(__doc__).parse_args()))
