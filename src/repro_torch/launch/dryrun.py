"""One-card dry-run: count every (architecture x input shape) cell's step on
the meta device and write one record per cell (mirrors
:mod:`repro.launch.dryrun`, for one H100).

The reference AOT-compiles each cell on 256- and 512-chip meshes of fake
CPU devices and reads XLA's ``cost_analysis``. Here the cell's step runs on
PyTorch's ``meta`` device, which carries shapes and dtypes and allocates
and computes nothing, so no card is used (as the reference's compiles on
fake devices use no TPU; this is not a CPU fallback: nothing is computed).
The step is the port's own:

- train: ``train.trainer._grad_fn`` with the reference's
  ``TRAIN_MICROBATCHES``, then ``optim.adamw.apply_updates``;
- prefill: ``serving.engine.make_prefill_step``;
- decode: ``serving.engine.make_serve_step`` at the cache's last position.

What is counted, per step:

- ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``, which
  counts matmul-class operations only (``mm``, ``bmm``, ``addmm``,
  convolutions, attention kernels), 2 FLOPs per multiply-add. XLA's count
  also holds elementwise work (norms, softmax, the optimizer), so this one
  is lower by that much. Remat recompute is counted, as in XLA's: under
  ``remat="block"`` the backward runs each block's forward again.
- ``bytes_accessed_per_device``: :class:`ByteCounter`, the bytes of every
  tensor argument and result of every operation that is not a view, as
  eager PyTorch dispatches them (an in-place operation's result is its
  argument, counted again). Eager operations are unfused, so this is an
  upper bound on XLA's post-fusion "bytes accessed".
- ``memory``: what the meta run can state: ``argument_size_in_bytes`` (the
  parameters, optimizer state and batch, or the parameters, tokens and
  cache) and ``output_size_in_bytes`` of the step. The temporaries' peak
  (XLA's ``temp_size_in_bytes``) is not known without running the step,
  and is left out.

The record has the reference's keys, with ``n_devices`` 1, ``collectives``
empty (one card), ``fsdp`` False, ``lower_s`` the meta run's wall and
``compile_s`` 0 (nothing is compiled). Cells that ``cell_supported``
refuses (``long_500k`` for full-attention archs) are written as ``skip``
records, as the reference writes them.

Cells go to ``<root>/dryrun_torch/h100x1/`` (``root``: the repository's
``artifacts/``), a directory the reference never globs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import ast
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as CN
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.core.costmodel import ARTIFACT_ROOT, CELL_DIR, MESH
from repro_torch.models.transformer import ModelConfig, get_model
from repro_torch.optim import adamw

# the reference's per-arch train settings (repro/launch/dryrun.py; its
# FSDP_ARCHS have no meaning on one card)
BF16_MOMENT_ARCHS = {"deepseek-v3-671b", "llama4-maverick-400b-a17b"}
TRAIN_MICROBATCHES = {
    "deepseek-v3-671b": 8, "llama4-maverick-400b-a17b": 8,
    "llama-3.2-vision-90b": 8, "granite-20b": 4, "granite-3-8b": 2,
    "stablelm-3b": 2, "llama3.2-1b": 2, "zamba2-1.2b": 2,
    "seamless-m4t-large-v2": 2, "xlstm-125m": 1,
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_view(func) -> bool:
    """An operation whose result aliases its argument without writing it
    (``_unsafe_view``, which ``reshape`` and ``einsum`` emit, is a view
    whose schema does not say so)."""
    return func is torch.ops.aten._unsafe_view.default or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor argument and result of each
    operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            self.bytes += _tree_bytes((args, kwargs, out))
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in pytree_leaves(tree))


def count(step: Callable[[], object]) -> Dict:
    """FLOPs, bytes and wall of one call of ``step`` (on meta tensors in
    the dry-run; the count is the same on any device), and the bytes of
    what it returns."""
    t0 = time.perf_counter()
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = ByteCounter()
    with flop_mode, bytes_mode:
        out = step()
    return {"flops": float(flop_mode.get_total_flops()),
            "bytes": float(bytes_mode.bytes),
            "output_bytes": _tree_bytes(out),
            "wall_s": time.perf_counter() - t0}


def cell_step(cfg: ModelConfig, spec: ShapeSpec, *, microbatches: int = 1,
              moment_dtype: str = "float32"):
    """``(step, argument bytes)``: the cell's step closed over meta
    parameters and inputs (and, to train, the optimizer state)."""
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.train.trainer import _grad_fn, trainable
    params, _ = CN.param_specs(cfg)
    ins = CN.input_specs(cfg, spec)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        params = trainable(params)
        opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
        opt_state = adamw.init_opt_state(opt_cfg, params)
        grads_of = _grad_fn(get_model(cfg), microbatches)

        def step():
            grads, loss, _ = grads_of(params, ins["batch"])
            new_p, new_o, _ = adamw.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
            return new_p, new_o, loss

        args = (params, opt_state, ins["batch"])
    elif spec.kind == "prefill":
        prefill_step = make_prefill_step(cfg, B, S, device="meta")

        def step():
            return prefill_step(params, ins["tokens"])

        args = (params, ins["tokens"])
    else:
        serve_step = make_serve_step(cfg, B, S, device="meta")

        def step():
            return serve_step(params, ins["tokens"], ins["cache"], S - 1)

        args = (params, ins["tokens"], ins["cache"], ins["pos"])
    return step, _tree_bytes(args)


def lower_cell(arch: str, shape_name: str,
               overrides: Optional[dict] = None) -> Dict:
    """One cell's record (the reference's ``lower_cell`` on one card)."""
    overrides = dict(overrides or {})
    mb_override = overrides.pop("microbatches", None)
    if overrides.pop("fsdp", False):
        raise NotImplementedError("FSDP needs repro.parallel, which the port "
                                  "has not got yet")
    cfg = CN.get_config(arch, **overrides)
    spec = SHAPES[shape_name]
    ok, reason = cell_supported(cfg.family, shape_name)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": MESH,
                 "kind": spec.kind, "seq_len": spec.seq_len,
                 "global_batch": spec.global_batch, "n_devices": 1,
                 "params": cfg.param_count(),
                 "active_params": cfg.active_param_count(),
                 "overrides": {k: str(v) for k, v in overrides.items()}}
    if not ok:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        return rec
    rec["fsdp"] = False
    kw = {}
    if spec.kind == "train":
        kw["microbatches"] = int(mb_override if mb_override is not None
                                 else TRAIN_MICROBATCHES.get(arch, 1))
        kw["moment_dtype"] = ("bfloat16" if arch in BF16_MOMENT_ARCHS
                              else "float32")
        rec["microbatches"] = kw["microbatches"]
    step, arg_bytes = cell_step(cfg, spec, **kw)
    c = count(step)
    rec.update({
        "status": "ok",
        "lower_s": c["wall_s"],
        "compile_s": 0.0,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": c["output_bytes"]},
        "flops_per_device": c["flops"],
        "bytes_accessed_per_device": c["bytes"],
        "cost_raw": {"flops": c["flops"], "bytes accessed": c["bytes"]},
        "collectives": {},
    })
    return rec


def cell_path(mesh_name: str, arch: str, shape_name: str,
              root: Optional[str] = None, tag: Optional[str] = None) -> str:
    d = os.path.join(root or ARTIFACT_ROOT, CELL_DIR, mesh_name)
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(d, f"{arch}__{shape_name}{suffix}.json")


def _lower_or_error(arch: str, shape_name: str,
                    overrides: Optional[dict]) -> Dict:
    try:
        return lower_cell(arch, shape_name, overrides)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": MESH,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def write_cells(archs: Iterable[str], shapes: Iterable[str], *,
                root: Optional[str] = None, force: bool = False,
                overrides: Optional[dict] = None, tag: Optional[str] = None,
                workers: int = 1, log: Callable = print) -> Dict:
    """Counts and writes each (arch, shape) cell not already written (all
    with ``force``); a cell that raises is written as an ``error`` record.
    ``workers > 1`` counts the cells in that many spawned processes (the
    count is single-threaded Python dispatch), train cells first. Returns
    ``{(arch, shape): record}`` of the cells written."""
    todo = []
    for arch in archs:
        for shape_name in shapes:
            path = cell_path(MESH, arch, shape_name, root, tag)
            if os.path.exists(path) and not force:
                log(f"[skip-cached] {arch} x {shape_name} ({MESH})")
            else:
                todo.append((arch, shape_name, path))
    if workers > 1:
        todo.sort(key=lambda c: SHAPES[c[1]].kind != "train")
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            futs = [ex.submit(_lower_or_error, a, sh, overrides)
                    for a, sh, _ in todo]
            recs = [f.result() for f in futs]
    else:
        recs = [_lower_or_error(a, sh, overrides) for a, sh, _ in todo]
    out = {}
    for (arch, shape_name, path), rec in zip(todo, recs):
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        extra = ""
        if rec["status"] == "ok":
            extra = (f" flops/dev={rec['flops_per_device']:.3e}"
                     f" bytes/dev={rec['bytes_accessed_per_device']:.3e}"
                     f" count={rec['lower_s']:.1f}s")
        elif rec["status"] == "error":
            extra = " " + rec["error"][:200]
        log(f"[count] {arch} x {shape_name} ({MESH}) -> {rec['status']}"
            f"{extra}")
        out[(arch, shape_name)] = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=CN.ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override k=v (ast-eval'd)")
    ap.add_argument("--tag", default=None,
                    help="artifact tag suffix (perf experiments)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes counting cells in parallel")
    ap.add_argument("--root", default=None,
                    help="artifact root (default: the repository's "
                         "artifacts/)")
    args = ap.parse_args(argv)
    archs = CN.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    write_cells(archs, shapes, root=args.root, force=args.force,
                overrides=overrides, tag=args.tag, workers=args.workers)


if __name__ == "__main__":
    main()
