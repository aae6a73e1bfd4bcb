"""Roofline cost model: the trace link between the LM stack and PipeSim
(mirrors :mod:`repro.core.costmodel`, on one NVIDIA H100).

Reads the one-card dry-run cells (``launch/dryrun.py``'s JSONs under
``<root>/dryrun_torch/<mesh>/``) and derives per-cell step-time estimates
from the three roofline terms. These feed back into the simulator as
*grounded* task-duration models: a "train arch X for K steps" pipeline task
gets its duration from the counted step instead of a fitted black-box GMM,
the paper's §IV "link that reconciles the experimentation environment to
the real system".

``root`` defaults to the repository's ``artifacts/``. The cells live in
``dryrun_torch/``, never in the reference's ``dryrun/``, whose catalog
would price them on its TPU spec.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.core import stats

ARTIFACT_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts"))
CELL_DIR = "dryrun_torch"
MESH = "h100x1"


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One accelerator's peaks. The field defaults are the reference's TPU
    v5e (``V5E``), kept so that both packages price one record on one
    spec alike."""

    name: str = "tpu_v5e"
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per ICI link
    hbm_bytes: float = 16e9


V5E = HardwareSpec()
# NVIDIA H100 Tensor Core GPU datasheet, SXM5 at 700 W (datasheet figures,
# not readings): dense bf16 tensor-core peak 989.4 TFLOP/s (1,979 with
# sparsity), HBM3 3.35 TB/s, NVLink 900 GB/s, 80 GB
H100 = HardwareSpec("h100_sxm5", peak_flops=989.4e12, hbm_bw=3.35e12,
                    ici_bw=900e9, hbm_bytes=80e9)


def roofline_terms(rec: Dict, hw: HardwareSpec = H100,
                   audit: Optional[Dict] = None) -> Dict:
    """Three roofline terms (seconds) for one dry-run cell record: the
    reference's arithmetic, term for term.

    ``audit`` is the reference's scan-corrected count
    (``benchmarks/roofline.py``): XLA counts a scanned layer stack once.
    The port's meta-device count walks every layer, so it has no
    undercount to correct and no audit is written for it."""
    n_dev = rec.get("n_devices", 256)
    if audit is not None:
        flops = audit["flops_per_device"]
        bytes_acc = audit["bytes_per_device"]
        coll_bytes = audit["collective_bytes_per_device"]
    else:
        flops = rec.get("flops_per_device", 0.0)
        bytes_acc = rec.get("bytes_accessed_per_device", 0.0)
        coll_bytes = sum(v["bytes"] for v in rec.get("collectives",
                                                     {}).values())
    compute_s = flops / hw.peak_flops
    memory_s = bytes_acc / hw.hbm_bw
    collective_s = coll_bytes / hw.ici_bw  # per-device link-bytes / link bw
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    # MODEL_FLOPS: 6*N*D total across devices (dense) / active for MoE
    n_active = rec.get("active_params", rec.get("params", 0))
    tokens = rec.get("seq_len", 0) * rec.get("global_batch", 0)
    if rec.get("kind") == "train":
        model_flops = 6.0 * n_active * tokens
    elif rec.get("kind") == "prefill":
        model_flops = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        model_flops = 2.0 * n_active * rec.get("global_batch", 0)
    useful_ratio = (model_flops / (flops * n_dev)) if flops > 0 else 0.0
    step_s = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "step_s": step_s,
        "model_flops": model_flops,
        "hlo_flops_total": flops * n_dev,
        "useful_ratio": useful_ratio,
        "roofline_fraction": (model_flops / n_dev / hw.peak_flops) / step_s
        if step_s > 0 else 0.0,
    }


def _read(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_cell(mesh: str, arch: str, shape: str, tag: Optional[str] = None,
              root: Optional[str] = None) -> Optional[Dict]:
    suffix = f"__{tag}" if tag else ""
    return _read(os.path.join(root or ARTIFACT_ROOT, CELL_DIR, mesh,
                              f"{arch}__{shape}{suffix}.json"))


def load_audit(mesh: str, arch: str, shape: str,
               root: Optional[str] = None) -> Optional[Dict]:
    """The scan-corrected audit of a cell, ``<root>/roofline/``. Nothing
    writes one for the port's cells (see :func:`roofline_terms`), so this
    is ``None`` unless a caller put one there."""
    return _read(os.path.join(root or ARTIFACT_ROOT, "roofline",
                              f"{mesh}__{arch}__{shape}.json"))


def arch_task_duration(arch: str, shape: str = "train_4k", mesh: str = MESH,
                       n_steps: int = 1000, jitter_sigma: float = 0.25,
                       hw: HardwareSpec = H100,
                       root: Optional[str] = None) -> Optional[stats.Dist]:
    """Duration distribution for an accelerator-cluster task of ``n_steps``
    train steps (or decode steps) of ``arch``: lognormal around the
    roofline step-time estimate. None if the cell wasn't dry-run yet."""
    rec = load_cell(mesh, arch, shape, root=root)
    if rec is None or rec.get("status") != "ok":
        return None
    audit = load_audit(mesh, arch, shape, root=root)
    terms = roofline_terms(rec, hw, audit)
    total = max(terms["step_s"] * n_steps, 1e-3)
    return stats._scalar_dist(stats.LOGNORMAL, float(np.log(total)),
                              jitter_sigma, 0.0)


def accelerator_workload_catalog(mesh: str = MESH, n_steps: int = 1000,
                                 hw: HardwareSpec = H100,
                                 root: Optional[str] = None
                                 ) -> Dict[str, stats.Dist]:
    """All archs with completed dry-runs -> grounded train-duration dists
    (the simulator's workload classes for an accelerator platform)."""
    out = {}
    for p in sorted(glob.glob(os.path.join(root or ARTIFACT_ROOT, CELL_DIR,
                                           mesh, "*__train_4k.json"))):
        arch = os.path.basename(p).split("__")[0]
        d = arch_task_duration(arch, "train_4k", mesh, n_steps, hw=hw,
                               root=root)
        if d is not None:
            out[arch] = d
    return out
