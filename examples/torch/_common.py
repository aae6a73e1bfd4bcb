"""Shared pieces of the PyTorch examples: the fitted simulation parameters
(the port's counterpart of ``benchmarks.common.fitted_params``), the
command line's ``--device`` and the examples' output directory.

The examples run on the card unless ``--device cpu`` is given; with no
card and no ``--device cpu`` they raise. Run them from the repository
root, e.g. ``PYTHONPATH=src python examples/torch/quickstart.py``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.core.fitting import SimulationParams, fit_simulation_params
from repro_torch.core.workload import generate_empirical_workload
from repro_torch.device import resolve_device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
PARAMS_PATH = os.path.join(ROOT, "artifacts", "pipesim_params.npz")
#: where the examples write their span and trace files (ignored by git)
OUT_DIR = os.path.join(ROOT, "build", "examples")

_cache = {}


def fitted_params(device=None, days: float = 14.0,
                  seed: int = 123) -> SimulationParams:
    """The committed fit (``artifacts/pipesim_params.npz``) on ``device``
    (``None``: the card). Without that file, a fit of ``days`` days of
    ground truth drawn with ``seed`` (the reference benchmarks' settings),
    kept in memory only: nothing is written under ``artifacts/``."""
    dev = resolve_device(device)
    key = (str(dev), days, seed)
    if key not in _cache:
        if os.path.exists(PARAMS_PATH):
            _cache[key] = SimulationParams.load(PARAMS_PATH, device=dev)
        else:
            wl = generate_empirical_workload(seed=seed,
                                             horizon_s=days * 86400.0)
            t0 = time.perf_counter()
            _cache[key] = fit_simulation_params(wl, device=dev)
            print(f"# fitted simulation params on {wl.n} pipelines in "
                  f"{time.perf_counter() - t0:.1f}s")
    return _cache[key]


def generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device``, seeded ``seed``."""
    return torch.Generator(resolve_device(device)).manual_seed(seed)


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default: the card)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    return ap
