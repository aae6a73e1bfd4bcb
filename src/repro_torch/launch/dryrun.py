"""Dry-run: count every (architecture x input shape) cell's step on the
meta device and write one record per cell (mirrors
:mod:`repro.launch.dryrun`), on one H100 (``--mesh h100x1``, the default)
or as rank 0 of the production meshes (``--mesh single``, 16 x 16 = 256
ranks; ``--mesh multi``, 2 x 16 x 16 = 512).

The reference AOT-compiles each cell on 256- and 512-chip meshes of fake
CPU devices and reads XLA's ``cost_analysis``. Here the cell's step runs on
PyTorch's ``meta`` device, which carries shapes and dtypes and allocates
and computes nothing, so no card is used (as the reference's compiles on
fake devices use no TPU; this is not a CPU fallback: nothing is computed).
The step is the port's own:

- train: ``train.trainer``'s microbatched gradient with the reference's
  ``TRAIN_MICROBATCHES``, then ``optim.adamw.apply_updates``; one
  microbatch is counted and taken ``TRAIN_MICROBATCHES`` times (each
  dispatches the same operations on the same shapes: the same count as
  the whole step's, in an eighth of the time for the MoE archs);
- prefill: ``serving.engine.make_prefill_step`` (with the VLM's patches or
  the encoder-decoder's frames as ``ctx``);
- decode: ``serving.engine.make_serve_step`` at the cache's last position.

The xLSTM's train and prefill cells are counted by their steps, without
running them all: every token of its recurrences, and every chunk of the
mLSTM's chunkwise form, dispatches the same operations on the same shapes,
and everything else is linear in the sequence length, so a cell's FLOPs
and bytes are affine in S once the chunk length is fixed, and affine in
the number of super blocks. :func:`count_lengths` picks two lengths ``S1
< S2`` (train: two and three chunks, the chunk pinned to the one the
cell's S takes; prefill, which runs the step recurrence over every prompt
token: 8 and 16 tokens) and two depths (one and two super blocks), and
:func:`count_cell` extrapolates the four counts to the cell in integers;
the record carries ``"counted_at"``. Counting ``train_4k`` whole would run
4,096 sLSTM steps per block forward, again under remat and backward, at
about 0.2 ms of Python per meta operation.

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
records, as the reference writes them. ``fsdp`` (an override) on one card
raises ``ValueError``: a one-device mesh has nothing to shard.

On ``single`` and ``multi`` a spawned worker joins a fake world of 256 or
512 ranks (:func:`repro_torch.launch.mesh.fake_production_mesh`) and
counts rank 0's step through the port's own mesh steps: the state placed
by ``trainer.state_shardings`` and ``make_train_step(cfg, opt, mesh,
fsdp=, microbatches=)``'s pieces, or the parameters placed by the
reference's rules and ``serving.engine``'s ``make_prefill_step`` /
``make_serve_step`` on the mesh. ``fsdp`` follows the reference's
``FSDP_ARCHS`` (or the override). The FLOP and byte counters see an
operation on a DTensor at its global shape, so only plain local tensors
are computed on: the parameters become rank 0's blocks
(:func:`~repro_torch.parallel.sharding.local_params`, no communication)
in a part of the count that tallies collectives only, then rank 0's rows
run, the step's :class:`~repro_torch.parallel.sharding.DPGather`
gathering each block the DP axes split where the model reads it (one
step of a stage at a time). What changes:

- ``n_devices`` 256 / 512; ``memory.argument_size_in_bytes`` rank 0's
  blocks of the parameters, the optimizer state and the batch rows, or of
  the parameters, the token rows and the cache blocks;
- ``flops_per_device`` and ``bytes_accessed_per_device``: rank 0's share.
  Its rows are the batch over the DP size, and every layer runs on its
  'model' block wherever the reference's rules split its leaves (GQA,
  MLA and cross-attention on its heads, the encoder, the MLPs on its mlp
  block, the head and loss on its vocabulary block, a MoE layer on its
  experts, the Mamba mixer and the xLSTM cells on their heads; not
  llama4's 40 heads or the xLSTM's 4 on 16, which stay whole), so these
  layers' FLOPs fall by the 'model' size as well. A MoE layer routes the
  global batch, as the reference's does: each rank's expert buffer holds
  ``min(capacity, local tokens)`` rows;
- ``collectives``: the reference's five categories (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) as ``{bytes, count}``, by the reference's rule:
  per collective the bytes of the largest tensor among its arguments and
  results, c10d and functional collectives alike: under FSDP the
  parameters' per-block DP gathers (in every train microbatch, prefill
  and decode step), and to train the backward's re-gathers and the
  gradients' reduce-scatters; the layers' all-reduces over 'model'
  (forward, and backward to train), the query's sequence split's
  all-gathers (where 'model' does not divide the heads: llama4's 40 on
  16), the decode's query/key/value (MLA: query, and plain ``wkv_b``) and
  logits gathers, the Mamba mixer's projection and conv-leaf gathers, the
  sLSTM's heads' gather, the cache moves, the sequence blocks' combine and
  the gradients' DP all-reduces. They are kept out of the FLOP and byte
  counts;
- ``dp_gather``: the step's DP gathers alone (``DPGather.counts``:
  ``gathers``, ``regathers``, ``reduce_scatters`` and their bytes, a train
  cell's taken ``microbatches`` times; ``high_bytes``, the most gathered
  bytes alive at once, is one microbatch's), all zero without FSDP.

Cells go to ``<root>/dryrun_torch/<mesh>/`` (``root``: the repository's
``artifacts/``), a directory the reference never globs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --workers 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
      --workers 4
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as CN
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.core.costmodel import ARTIFACT_ROOT, CELL_DIR, MESH
from repro_torch.models.transformer import ModelConfig, get_model
from repro_torch.models.xlstm import mlstm_chunk
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as Sh

# the meshes a cell is counted on, each with its ``multi_pod``: one card,
# or rank 0 of the production meshes (the reference's --mesh names)
MESHES = {MESH: None, "single": False, "multi": True}
# the reference's per-arch train settings (repro/launch/dryrun.py)
FSDP_ARCHS = {"deepseek-v3-671b", "llama4-maverick-400b-a17b",
              "llama-3.2-vision-90b", "granite-20b"}
BF16_MOMENT_ARCHS = {"deepseek-v3-671b", "llama4-maverick-400b-a17b"}
TRAIN_MICROBATCHES = {
    "deepseek-v3-671b": 8, "llama4-maverick-400b-a17b": 8,
    "llama-3.2-vision-90b": 8, "granite-20b": 4, "granite-3-8b": 2,
    "stablelm-3b": 2, "llama3.2-1b": 2, "zamba2-1.2b": 2,
    "seamless-m4t-large-v2": 2, "xlstm-125m": 1,
}


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d's and the functional collectives' operations, by category
_CATEGORY = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _nbytes(t) -> int:
    """A tensor's bytes; a DTensor's, this rank's block's."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_comm(func) -> bool:
    return func.namespace in ("c10d", "_c10d_functional")


def empty_collectives() -> Dict:
    return {c: {"bytes": 0, "count": 0} for c in COLLECTIVES}


class CollectiveCounter(TorchDispatchMode):
    """Tallies each collective by the reference's rule: per category, the
    count and the bytes of the largest tensor among each call's arguments
    and results. ``calls`` lists ``(category, bytes)`` in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cat = _CATEGORY.get(func._schema.name.split("::")[-1]) \
            if _is_comm(func) else None
        if cat is not None:
            self.calls.append((cat, max(
                (_nbytes(t) for t in pytree_leaves((args, kwargs, out))),
                default=0)))
        return out

    def tally(self) -> Dict:
        out = empty_collectives()
        for cat, nbytes in self.calls:
            out[cat]["bytes"] += nbytes
            out[cat]["count"] += 1
        return out


def _is_view(func) -> bool:
    """An operation whose result aliases its argument without writing it
    (``_unsafe_view``, which ``reshape`` and ``einsum`` emit, is a view
    whose schema does not say so)."""
    return func is torch.ops.aten._unsafe_view.default or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor argument and result of each
    operation that is not a view or a collective."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (_is_view(func) or _is_comm(func)):
            self.bytes += _tree_bytes((args, kwargs, out))
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in pytree_leaves(tree))


def count(step: Callable[[], object]) -> Dict:
    """FLOPs and bytes (integers), the collectives (a
    :class:`CollectiveCounter` tally) and the wall of one call of ``step``
    (on meta tensors in the dry-run; the count is the same on any device),
    and the bytes of what it returns. A step with ``parts``, ``((fn,
    times), ...)`` run in order, is counted as its parts: each ``fn`` run
    once and its counts taken ``times`` times (a microbatch's gradient,
    which every microbatch repeats on the same shapes), the output the
    last part's. A part ``(fn, times, "collectives")`` adds its
    collectives only (the parameters' gathers). A step with ``dp_gather``,
    ``(DPGather, times)``, adds that gather's counts, taken ``times``
    times (``"dp_gather"``)."""
    parts = getattr(step, "parts", None) or ((step, 1),)
    gather, dp_times = getattr(step, "dp_gather", (None, 1))
    if gather is not None:
        gather.reset()
    t0 = time.perf_counter()
    flops = nbytes = 0
    coll = empty_collectives()
    for fn, times, *only in parts:
        comm = CollectiveCounter()
        if only:
            with comm:
                fn()
        else:
            flop_mode = FlopCounterMode(display=False)
            bytes_mode = ByteCounter()
            with flop_mode, bytes_mode, comm:
                out = fn()
            flops += times * flop_mode.get_total_flops()
            nbytes += times * bytes_mode.bytes
        for c, v in comm.tally().items():
            coll[c]["bytes"] += times * v["bytes"]
            coll[c]["count"] += times * v["count"]
    out = {"flops": int(flops), "bytes": int(nbytes),
           "output_bytes": _tree_bytes(out), "collectives": coll,
           "wall_s": time.perf_counter() - t0}
    if gather is not None:
        out["dp_gather"] = {k: v if k == "high_bytes" else v * dp_times
                            for k, v in gather.counts().items()}
    return out


def cell_step(cfg: ModelConfig, spec: ShapeSpec, *, microbatches: int = 1,
              moment_dtype: str = "float32", mesh=None, fsdp: bool = False):
    """``(step, argument bytes)``: the cell's step closed over meta
    parameters and inputs (and, to train, the optimizer state). A train
    step of several microbatches also carries ``parts`` for
    :func:`count`: the accumulators' start, one microbatch (taken
    ``microbatches`` times), then the average and the update. On a
    ``mesh`` it is rank 0's step (:func:`mesh_cell_step`)."""
    if mesh is not None:
        return mesh_cell_step(cfg, spec, mesh, fsdp=fsdp,
                              microbatches=microbatches,
                              moment_dtype=moment_dtype)
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.train import trainer
    params, _ = CN.param_specs(cfg)
    ins = CN.input_specs(cfg, spec)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        params = trainer.trainable(params)
        opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
        opt_state = adamw.init_opt_state(opt_cfg, params)
        model = get_model(cfg)
        grads_of = trainer._grad_fn(model, microbatches)

        def update(grads, loss):
            new_p, new_o, _ = adamw.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
            return new_p, new_o, loss

        def step():
            grads, loss, _ = grads_of(params, ins["batch"])
            return update(grads, loss)

        if microbatches > 1:
            start, micro, finish = trainer.microbatch_parts(
                trainer._value_and_grad(model), microbatches)
            acc = {}

            def first():
                acc["a"] = start(params)
                return acc["a"]

            def one():
                acc["a"] = micro(acc["a"], params, ins["batch"], 0)
                return acc["a"]

            def last():
                return update(*finish(acc["a"])[:2])

            step.parts = ((first, 1), (one, microbatches), (last, 1))
        args = (params, opt_state, ins["batch"])
    elif spec.kind == "prefill":
        prefill_step = make_prefill_step(cfg, B, S, device="meta")

        def step():
            return prefill_step(params, ins["tokens"], ins.get("ctx"))

        args = (params, ins["tokens"], ins.get("ctx"))
    else:
        serve_step = make_serve_step(cfg, B, S, device="meta")

        def step():
            return serve_step(params, ins["tokens"], ins["cache"], S - 1)

        args = (params, ins["tokens"], ins["cache"], ins["pos"])
    return step, _tree_bytes(args)


def _local(tree):
    """Each DTensor leaf's local block."""
    return Sh._map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                   tree)


def mesh_cell_step(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
                   fsdp: bool, microbatches: int = 1,
                   moment_dtype: str = "float32"):
    """``(step, argument bytes)`` of rank 0 on ``mesh`` (a ``DeviceMesh``
    of the fake world): the state, or the parameters, placed by the
    reference's rules (``fsdp``) as DTensors of rank 0's blocks; a train
    step in :func:`count`'s parts, the first of which takes rank 0's
    blocks (``pieces["local"]``, which moves nothing) and tallies
    collectives only; a serving step takes the DTensors. The argument
    bytes are rank 0's blocks and rows."""
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.train import trainer
    full, axes = CN.param_specs(cfg)
    ins = CN.input_specs(cfg, spec)
    B, S = spec.global_batch, spec.seq_len
    coord = tuple(mesh.get_coordinate())
    st: Dict = {}
    if spec.kind == "train":
        opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
        params = trainer.trainable(full)
        sh = trainer.state_shardings(cfg, mesh, fsdp=fsdp)
        placed = trainer.shard_state(
            {"params": params,
             "opt_state": adamw.init_opt_state(opt_cfg, params)},
            {"params": sh["params"], "opt_state": sh["opt_state"]})
        params, opt_state = placed["params"], placed["opt_state"]
        pieces = trainer.make_train_step(
            cfg, opt_cfg, mesh, fsdp=fsdp,
            microbatches=microbatches).pieces
        ms = pieces["mesh_step"]
        rows = ms.rows(ins["batch"], microbatches)
        start, micro, average = trainer.microbatch_parts(
            trainer._value_and_grad(get_model(cfg)), microbatches)

        def gather():
            st["full"] = pieces["local"](params)

        def first():
            st["a"] = start(st["full"])
            return st["a"]

        def one():
            with ms.context(ins["batch"], ms.dp):
                st["a"] = micro(st["a"], st["full"], rows, 0)
            return st["a"]

        def step():
            return pieces["finish"](params, opt_state, *average(st["a"]))

        step.parts = ((gather, 1, "collectives"), (first, 1),
                      (one, microbatches), (step, 1))
        step.dp_gather = (ms.gather, microbatches)
        return step, _tree_bytes(_local((params, opt_state, rows)))

    rules = Sh.make_rules(fsdp=fsdp, data_axes=Sh.dp_axes(mesh))
    params = trainer.shard_state(full, Sh.param_shardings(axes, full, mesh,
                                                          rules))

    def rows(t):
        return t[Sh.batch_shardings({"t": t}, mesh)["t"].block(
            tuple(t.shape), coord)]

    if spec.kind == "prefill":
        prefill_step, _ = make_prefill_step(cfg, B, S, device="meta",
                                            mesh=mesh)
        serving = prefill_step.mesh_serve

        def step():
            return prefill_step(params, ins["tokens"], ins.get("ctx"))

        args = (params, rows(ins["tokens"]),
                None if ins.get("ctx") is None else rows(ins["ctx"]))
    else:
        serve_step, cache_sh, _ = make_serve_step(cfg, B, S, device="meta",
                                                  mesh=mesh)
        serving = serve_step.mesh_serve
        cache = Sh._map(lambda t, sh: t[sh.block(tuple(t.shape), coord)],
                        ins["cache"], cache_sh)

        def step():
            return serve_step(params, ins["tokens"], cache, S - 1)

        args = (params, rows(ins["tokens"]), cache, ins["pos"])
    step.dp_gather = (serving.bind().gather, 1)
    return step, _tree_bytes(_local(args))


PREFILL_COUNT_LENGTHS = (8, 16)
COUNT_LAYERS = (2, 4)       # one and two super blocks


def count_lengths(cfg: ModelConfig, spec: ShapeSpec) -> Optional[tuple]:
    """``(S1, S2, overrides, layers)``: the lengths at which an xLSTM train
    or prefill cell is counted, the config overrides that keep its chunk,
    and ``COUNT_LAYERS`` where the config is deeper (else ``None``: counted
    at its own depth); ``None`` for a cell counted whole (every other
    family, every decode cell, and a train cell whose chunk is its whole
    sequence, whose in-chunk work is quadratic in S).

    A train cell's lengths are two and three chunks: the first chunk and
    the first token of each recurrence start from a state that needs no
    gradient, and the last ones end in a state the loss does not read, so
    only the chunks between are alike."""
    S = spec.seq_len
    if cfg.family != "ssm" or spec.kind == "decode":
        return None
    if spec.kind == "prefill":
        S1, S2 = PREFILL_COUNT_LENGTHS
        over = {}
    else:
        q = mlstm_chunk(S, cfg.attn_q_chunk)
        S1, S2, over = 2 * q, 3 * q, {"attn_q_chunk": q}
    if S <= S2 or (S - S1) % (S2 - S1):
        return None
    layers = COUNT_LAYERS if cfg.n_layers > COUNT_LAYERS[1] else None
    return S1, S2, over, layers


def count_cell(cfg: ModelConfig, spec: ShapeSpec, **kw) -> tuple:
    """``(count, argument bytes, counted_at)`` of one cell's step: counted
    whole (``counted_at`` None), or at :func:`count_lengths`' lengths (and
    depths) and extrapolated to the cell's in integers. The count is affine
    in S (each middle chunk and token alike) and in the number of super
    blocks (each block alike, its parameters unbound once), so bilinear in
    the two: four counts fix it. The output bytes are the deeper, longer
    count's scaled in depth (the xLSTM's outputs do not grow with S); the
    argument bytes are the true cell's. ``counted_at`` is ``[S1, S2]``, or
    ``{"seq_len": [S1, S2], "n_layers": [L1, L2]}``."""
    step, arg_bytes = cell_step(cfg, spec, **kw)
    lengths = count_lengths(cfg, spec)
    if lengths is None:
        return count(step), arg_bytes, None
    del step
    S1, S2, over, layers = lengths
    L1, L2 = layers or (cfg.n_layers, cfg.n_layers)

    def at(S, L):
        c = dataclasses.replace(cfg, n_layers=L, **over)
        return count(cell_step(c, dataclasses.replace(spec, seq_len=S),
                               **kw)[0])

    f = {(S, L): at(S, L) for L in dict.fromkeys((L1, L2))
         for S in (S1, S2)}
    ks = (spec.seq_len - S1) // (S2 - S1)
    kl = (cfg.n_layers - L1) // (L2 - L1) if layers else 0    # super blocks

    def extrapolate(get):
        f11, f21 = get(f[S1, L1]), get(f[S2, L1])
        f12, f22 = get(f[S1, L2]), get(f[S2, L2])
        return (f11 + ks * (f21 - f11) + kl * (f12 - f11)
                + ks * kl * (f22 - f21 - f12 + f11))

    c = {key: extrapolate(lambda x, key=key: x[key])
         for key in ("flops", "bytes")}
    c["collectives"] = {
        cat: {k: extrapolate(lambda x, cat=cat, k=k: x["collectives"][cat][k])
              for k in ("bytes", "count")} for cat in COLLECTIVES}
    out1, out2 = f[S2, L1]["output_bytes"], f[S2, L2]["output_bytes"]
    c.update(output_bytes=out1 + kl * (out2 - out1),
             wall_s=sum(x["wall_s"] for x in f.values()))
    at_ = [S1, S2] if layers is None else {"seq_len": [S1, S2],
                                           "n_layers": list(layers)}
    return c, arg_bytes, at_


# the production mesh of this process's fake world, by its --mesh name
# (set by :func:`join_mesh_world` in a spawned worker)
_WORLD: Dict = {}


def join_mesh_world(mesh_name: str) -> None:
    """Join this process to the fake world of ``mesh_name`` ("single" or
    "multi") and keep its production mesh: a spawned worker's
    initializer. The group lives as long as the process."""
    from repro_torch.launch.mesh import fake_production_mesh
    _WORLD[mesh_name] = fake_production_mesh(multi_pod=MESHES[mesh_name])


def lower_cell(arch: str, shape_name: str,
               overrides: Optional[dict] = None,
               mesh_name: str = MESH) -> Dict:
    """One cell's record (the reference's ``lower_cell``): on one card, or
    as rank 0 of the production mesh ``mesh_name`` ("single", "multi"),
    in a process that :func:`join_mesh_world` joined to its fake world."""
    overrides = dict(overrides or {})
    mb_override = overrides.pop("microbatches", None)
    fsdp_override = overrides.pop("fsdp", None)
    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name!r}; one of "
                         f"{list(MESHES)}")
    mesh = None
    if MESHES[mesh_name] is None:
        if fsdp_override:
            raise ValueError("fsdp shards the state over a mesh's DP axes; "
                             f"the {MESH} dry-run has one device: count "
                             "FSDP cells on --mesh single or multi")
    else:
        mesh = _WORLD.get(mesh_name)
        if mesh is None:
            raise RuntimeError(f"the {mesh_name} cells are counted in a "
                               "fake world: call join_mesh_world first in a "
                               "process of its own (write_cells does)")
    cfg = CN.get_config(arch, **overrides)
    spec = SHAPES[shape_name]
    ok, reason = cell_supported(cfg.family, shape_name)
    n_dev = 1 if mesh is None else math.prod(Sh.mesh_shape(mesh).sizes)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": spec.kind, "seq_len": spec.seq_len,
                 "global_batch": spec.global_batch, "n_devices": n_dev,
                 "params": cfg.param_count(),
                 "active_params": cfg.active_param_count(),
                 "overrides": {k: str(v) for k, v in overrides.items()}}
    if not ok:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        return rec
    fsdp = mesh is not None and (arch in FSDP_ARCHS if fsdp_override is None
                                 else bool(fsdp_override))
    rec["fsdp"] = fsdp
    kw = {} if mesh is None else {"mesh": mesh, "fsdp": fsdp}
    if spec.kind == "train":
        kw["microbatches"] = int(mb_override if mb_override is not None
                                 else TRAIN_MICROBATCHES.get(arch, 1))
        kw["moment_dtype"] = ("bfloat16" if arch in BF16_MOMENT_ARCHS
                              else "float32")
        rec["microbatches"] = kw["microbatches"]
    c, arg_bytes, counted_at = count_cell(cfg, spec, **kw)
    if counted_at is not None:
        rec["counted_at"] = counted_at
    rec.update({
        "status": "ok",
        "lower_s": c["wall_s"],
        "compile_s": 0.0,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": c["output_bytes"]},
        "flops_per_device": float(c["flops"]),
        "bytes_accessed_per_device": float(c["bytes"]),
        "cost_raw": {"flops": float(c["flops"]),
                     "bytes accessed": float(c["bytes"])},
        "collectives": {} if mesh is None else c["collectives"],
    })
    if mesh is not None and "dp_gather" in c:
        rec["dp_gather"] = c["dp_gather"]
    return rec


def cell_path(mesh_name: str, arch: str, shape_name: str,
              root: Optional[str] = None, tag: Optional[str] = None) -> str:
    d = os.path.join(root or ARTIFACT_ROOT, CELL_DIR, mesh_name)
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(d, f"{arch}__{shape_name}{suffix}.json")


def _lower_or_error(arch: str, shape_name: str,
                    overrides: Optional[dict], mesh_name: str = MESH) -> Dict:
    try:
        return lower_cell(arch, shape_name, overrides, mesh_name)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def write_cells(archs: Iterable[str], shapes: Iterable[str], *,
                root: Optional[str] = None, force: bool = False,
                overrides: Optional[dict] = None, tag: Optional[str] = None,
                workers: int = 1, log: Callable = print,
                mesh_name: str = MESH) -> Dict:
    """Counts and writes each (arch, shape) cell of ``mesh_name`` not
    already written (all with ``force``); a cell that raises is written as
    an ``error`` record. ``workers > 1`` counts the cells in that many
    spawned processes (the count is single-threaded Python dispatch),
    train cells first; the cells of ``single`` and ``multi`` are always
    counted in spawned processes, each joined to its fake world. Returns
    ``{(arch, shape): record}`` of the cells written."""
    todo = []
    for arch in archs:
        for shape_name in shapes:
            path = cell_path(mesh_name, arch, shape_name, root, tag)
            if os.path.exists(path) and not force:
                log(f"[skip-cached] {arch} x {shape_name} ({mesh_name})")
            else:
                todo.append((arch, shape_name, path))
    meshed = MESHES.get(mesh_name, None) is not None
    if todo and (workers > 1 or meshed):
        todo.sort(key=lambda c: SHAPES[c[1]].kind != "train")
        ctx = multiprocessing.get_context("spawn")
        init = dict(initializer=join_mesh_world,
                    initargs=(mesh_name,)) if meshed else {}
        with ProcessPoolExecutor(max(workers, 1), mp_context=ctx,
                                 **init) as ex:
            futs = [ex.submit(_lower_or_error, a, sh, overrides, mesh_name)
                    for a, sh, _ in todo]
            recs = [f.result() for f in futs]
    else:
        recs = [_lower_or_error(a, sh, overrides, mesh_name)
                for a, sh, _ in todo]
    out = {}
    for (arch, shape_name, path), rec in zip(todo, recs):
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        extra = ""
        if rec["status"] == "ok":
            extra = (f" flops/dev={rec['flops_per_device']:.3e}"
                     f" bytes/dev={rec['bytes_accessed_per_device']:.3e}"
                     f" count={rec['lower_s']:.1f}s")
            if "counted_at" in rec:
                extra += f" counted_at={rec['counted_at']}"
        elif rec["status"] == "error":
            extra = " " + rec["error"][:200]
        log(f"[count] {arch} x {shape_name} ({mesh_name}) -> "
            f"{rec['status']}"
            f"{extra}")
        out[(arch, shape_name)] = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=CN.ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=MESH, choices=list(MESHES),
                    help="one card, or rank 0 of the 16 x 16 (single) or "
                         "2 x 16 x 16 (multi) production mesh")
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
                overrides=overrides, tag=args.tag, workers=args.workers,
                mesh_name=args.mesh)


if __name__ == "__main__":
    main()
