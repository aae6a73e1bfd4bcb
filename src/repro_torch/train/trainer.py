"""Training step builders (mirrors :mod:`repro.train.trainer`): the step
on one device, the sharded step on a mesh (DP, FSDP) and the multi-pod
step with a compressed pod-level reduction.

A step is the gradient of the model's ``loss_fn`` (``torch.autograd.grad``
in place of ``jax.value_and_grad``), then :func:`repro_torch.optim.adamw.
apply_updates`. Parameters are leaf tensors that require grad; the step
returns new trees, as the reference's does. Microbatches split the batch as
the reference does (microbatch j holds rows j, j + mb, ...), accumulate the
gradients in f32 and report the last microbatch's metrics.

On a mesh (a ``DeviceMesh``, :mod:`repro_torch.launch.mesh`) the state at
rest is DTensors placed by :func:`state_shardings`: 'model' splits the
heads, MLP, vocabulary and experts (the reference's rules), and under FSDP
each rank holds ``1/(data*model)`` of most leaves. The parameters are dict
trees, not ``nn.Module``s, so the sharded step is written in plain
``torch.distributed``: (1) each parameter is gathered over the DP axes
only: a leaf that 'model' splits stays in this rank's 'model' block where
its layer runs tensor or expert parallel (GQA attention, the MLPs, the
vocabulary, the routed and shared experts), and is gathered whole where it
does not (MLA, the Mamba and xLSTM blocks, cross-attention, the encoder;
:func:`~repro_torch.parallel.sharding.local_params`); (2) the forward and
backward run on this rank's rows of the batch (sharded over the DP axes as
:func:`~repro_torch.parallel.sharding.batch_shardings` says), each
parallel layer computing its share and combining the shares over 'model'
through explicit collectives (Megatron's ``to_model`` / ``from_model``);
(3) the gradients are averaged over the DP axes, a 'model' block staying a
block; (4) they are clipped by the whole gradient's norm (the blocks' sums
of squares all-reduced over 'model', each element counted once), as
``apply_updates`` does, and (5) this rank's shards of the parameters and
moments are updated. A MoE layer routes the global batch, as the
reference's global program does
(:class:`~repro_torch.parallel.sharding.TokenGroup`; the compressed step:
each pod's batch). On a mesh whose 'model' axis has one rank nothing is
split, and on a mesh of one rank the step is the one-device step's, bit for
bit. The compressed step averages each pod's gradient over its 'data'
ranks, then runs it through
:func:`~repro_torch.parallel.compression.compressed_psum_pod` over the
mesh's 'pod' group; a 'model' block is compressed as its whole leaf (the
int8 scale and the top-k threshold come from the 'model' group).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import param_specs
from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.transformer import (ModelConfig, get_model,
                                            model_parallel_leaf)
from repro_torch.optim import adamw
from repro_torch.parallel import compression as C
from repro_torch.parallel import sharding as Sh


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    err_state: Any = None  # compression error feedback


def init_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     seed: int = 0, device=None,
                     comp: Optional[C.CompressionConfig] = None
                     ) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (``None``: the card),
    each requiring grad, and zero moments; with ``comp``, the zero error
    feedback of :func:`~repro_torch.parallel.compression.init_error_state`
    (``None`` when ``comp`` feeds nothing back)."""
    params = trainable(get_model(cfg).init(seed, device))
    err = C.init_error_state(comp, params) if comp is not None else None
    return TrainState(params, adamw.init_opt_state(opt_cfg, params), err)


def trainable(params):
    """``params`` as leaf tensors that require grad."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def _value_and_grad(model) -> Callable:
    """``value_and_grad(params, batch) -> (grads, loss, metrics)``."""
    def value_and_grad(params, batch):
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        return (tree_unflatten(params, grads), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return value_and_grad


def microbatch_parts(value_and_grad: Callable, microbatches: int):
    """The microbatched gradient in three parts: ``start(params) -> acc``,
    ``micro(acc, params, batch, j) -> acc`` (microbatch ``j``: rows ``j::
    microbatches``, the reference's ``[B] -> [B//mb, mb] -> swapaxes``)
    and ``finish(acc) -> (grads, loss, metrics)``. Every ``micro`` call
    dispatches the same operations on the same shapes, so the dry-run
    counts one and scales it (``launch/dryrun.py``)."""
    def start(params):
        acc_g = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        acc_l = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        return acc_g, acc_l, None

    def micro(acc, params, batch, j: int):
        acc_g, acc_l, _ = acc
        one = {k: v[j::microbatches] for k, v in batch.items()}
        grads, loss, metrics = value_and_grad(params, one)
        return (tree_map(lambda a, g: a + g.float(), acc_g, grads),
                acc_l + loss, metrics)

    def finish(acc):
        acc_g, acc_l, metrics = acc
        inv = 1.0 / microbatches
        return tree_map(lambda g: g * inv, acc_g), acc_l * inv, metrics

    return start, micro, finish


def _grad_fn(model, microbatches: int) -> Callable:
    """``grads_of(params, batch) -> (grads, loss, metrics)``."""
    value_and_grad = _value_and_grad(model)
    if microbatches <= 1:
        return value_and_grad
    start, micro, finish = microbatch_parts(value_and_grad, microbatches)

    def grads_of(params, batch):
        acc = start(params)
        for j in range(microbatches):
            acc = micro(acc, params, batch, j)
        return finish(acc)

    return grads_of


def state_shardings(cfg: ModelConfig, mesh, *, fsdp: bool = False) -> Dict:
    """:class:`~repro_torch.parallel.sharding.NamedSharding` trees for the
    train state: parameters from the axes tree and the rules, the moments
    following them, ``step`` replicated."""
    shapes, axes = param_specs(cfg)
    rules = Sh.make_rules(fsdp=fsdp, data_axes=Sh.dp_axes(mesh))
    ps = Sh.param_shardings(axes, shapes, mesh, rules)
    return {"params": ps,
            "opt_state": {"m": ps, "v": ps, "step": Sh.replicated(mesh)},
            "err_state": None}


def shard_state(tree, shardings):
    """``tree`` (the same full leaves on every rank) as DTensors placed by
    ``shardings``, a tree of its structure: each rank keeps its blocks."""
    return tree_map(Sh.distribute, tree, shardings)


class _MeshStep:
    """What a sharded step needs of its mesh: this rank's coordinate, the
    DP axes' groups and sizes, and its 'model' group."""

    def __init__(self, cfg, mesh, fsdp: bool):
        self.mesh = mesh
        self.shardings = state_shardings(cfg, mesh, fsdp=fsdp)
        self.coord = tuple(mesh.get_coordinate())
        self.dp = Sh.dp_axes(mesh)
        self.sizes = Sh.mesh_shape(mesh).shape
        self.mg = Sh.model_group_of(mesh, self.coord)
        model = get_model(cfg)
        size = self.sizes.get("model", 1)
        self.keep = lambda path: model_parallel_leaf(model, path, size)

    def local(self, params):
        """The parameters the forward and backward run on, as leaves that
        require grad: each gathered over the DP axes, a 'model'-split leaf
        of a parallel layer kept in its 'model' block, any other gathered
        whole (:func:`~repro_torch.parallel.sharding.local_params`)."""
        return tree_map(lambda t: t.detach().requires_grad_(),
                        Sh.local_params(params, self.keep))

    def context(self, batch, axes):
        """The step's groups: the MoE routing's over the DP ``axes`` and
        this rank's 'model' group."""
        stack = contextlib.ExitStack()
        stack.enter_context(Sh.token_group(self.group(batch, axes)))
        stack.enter_context(Sh.model_parallel(self.mg))
        return stack

    def rows(self, batch, microbatches: int = 1):
        """This rank's rows of each leaf of ``batch`` (the global batch,
        on every rank), as ``batch_shardings`` places them."""
        batch = {k: v.full_tensor() if isinstance(v, DTensor) else v
                 for k, v in batch.items()}
        sh = Sh.batch_shardings(batch, self.mesh)
        out = {k: v[sh[k].block(tuple(v.shape), self.coord)]
               for k, v in batch.items()}
        for k, v in out.items():
            if v.shape[0] % microbatches:
                raise ValueError(
                    f"{k}: this rank's {v.shape[0]} rows do not split into "
                    f"{microbatches} microbatches")
        return out

    def group(self, batch, axes):
        """The MoE routing group of this rank's rows of ``batch``: the
        ranks of the DP ``axes`` whose rows make the batch the reference
        routes (``None`` where every rank holds every row)."""
        spec = Sh.batch_shardings({"t": batch["tokens"]}, self.mesh)["t"].spec
        split = bool(spec) and spec[0] is not None
        return Sh.token_group_of(self.mesh, self.coord, axes, aux=True) \
            if split else None

    def mean(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over the mesh ``axes`` and divided by their size,
        in place (a metric may share its storage with the loss: pass a
        clone). NCCL reduces contiguous tensors only: a gradient that
        autograd laid out otherwise is reduced in a contiguous copy and
        copied back, so it keeps its layout (and the clip norm its order
        of summation)."""
        buf = t if t.is_contiguous() else t.contiguous()
        for a in axes:
            dist.all_reduce(buf, group=self.mesh.get_group(a))
        buf.div_(math.prod(self.sizes[a] for a in axes))
        return t if buf is t else t.copy_(buf)

    def split(self, grads, params) -> list:
        """Per leaf (in ``tree_leaves`` order), whether its gradient is a
        'model' block: its shape is not the parameter's global one."""
        return [tuple(g.shape) != tuple(p.shape) for g, p in
                zip(tree_leaves(grads), tree_leaves(params))]

    def global_norm(self, grads, params) -> torch.Tensor:
        """The norm of the whole gradient, each element counted once: the
        sums of squares of the 'model' blocks all-reduced over the 'model'
        group (one call), added in the leaves' order to those of the
        leaves every rank holds whole (``adamw.global_norm``'s order)."""
        split = self.split(grads, params)
        if not any(split):
            return adamw.global_norm(grads)
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
        idx = [i for i, s in enumerate(split) if s]
        summed = self.mg.all_reduce(torch.stack([sq[i] for i in idx]))
        for j, i in enumerate(idx):
            sq[i] = summed[j]
        return torch.sqrt(sum(sq))

    def model_block(self, t, like, sharding) -> torch.Tensor:
        """``t`` cut to this rank's 'model' block of ``sharding`` where
        ``like`` (a gradient) is such a block and ``t`` still whole."""
        if tuple(t.shape) == tuple(like.shape):
            return t
        d = Sh.model_dim(sharding.spec)
        return t[(slice(None),) * d + (self.mg.block(t.shape[d]),)]

    def cut(self, g, sharding, param) -> torch.Tensor:
        """This rank's block of the gradient ``g`` of ``param`` (whole over
        the DP axes): the block of ``sharding``, less its 'model' entry
        where ``g`` is already a 'model' block."""
        spec = sharding.spec
        if tuple(g.shape) != tuple(param.shape):
            d = Sh.model_dim(spec)
            spec = spec[:d] + (None,) + spec[d + 1:]
        return g[Sh.NamedSharding(self.mesh, spec).block(tuple(g.shape),
                                                          self.coord)]

    def update(self, opt_cfg, params, opt_state, grads):
        """This rank's shards of the parameters and moments updated by the
        whole averaged ``grads`` (clipped by their norm), as DTensors."""
        gnorm = self.global_norm(grads, params)
        local = lambda t: t.to_local()
        g_loc = tree_map(self.cut, grads, self.shardings["params"], params)
        new_p, new_opt, opt_m = adamw.apply_updates(
            opt_cfg, tree_map(local, params), g_loc,
            {"m": tree_map(local, opt_state["m"]),
             "v": tree_map(local, opt_state["v"]),
             "step": opt_state["step"].to_local()}, gnorm=gnorm)

        def back(t, ref):
            return DTensor.from_local(t, ref.device_mesh, ref.placements,
                                      run_check=False, shape=ref.shape,
                                      stride=ref.stride())

        return (tree_map(back, new_p, params),
                {"m": tree_map(back, new_opt["m"], opt_state["m"]),
                 "v": tree_map(back, new_opt["v"], opt_state["v"]),
                 "step": back(new_opt["step"], opt_state["step"])}, opt_m)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, *, fsdp: bool = False,
                    microbatches: int = 1) -> Callable:
    """The train step ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``metrics`` holds the loss, the last
    microbatch's ``ce_loss`` (and ``aux_loss``), the gradient norm and the
    learning rate. With no ``mesh`` it runs on the device of its inputs;
    on a ``mesh`` the state is DTensors placed by
    ``state_shardings(cfg, mesh, fsdp=fsdp)`` (:func:`shard_state`) and
    ``batch`` the global batch on every rank, and the loss and metrics are
    the global batch's means. The reference's ``donate`` has no
    counterpart: the old trees are freed once the caller drops them."""
    grads_of = _grad_fn(get_model(cfg), microbatches)
    if mesh is None:
        if fsdp:
            raise ValueError("fsdp shards the state over a mesh's DP axes: "
                             "pass a mesh")

        def step_fn(params, opt_state, batch):
            grads, loss, metrics = grads_of(params, batch)
            new_params, new_opt, opt_m = adamw.apply_updates(
                opt_cfg, params, grads, opt_state)
            metrics = dict(metrics)
            metrics.update(opt_m)
            metrics["loss"] = loss
            return new_params, new_opt, metrics

        return step_fn

    ms = _MeshStep(cfg, mesh, fsdp)

    def finish(params, opt_state, grads, loss, metrics):
        """Steps (3)-(5) of the module docstring, and the metrics' means."""
        for g in tree_leaves(grads):
            ms.mean(g, ms.dp)
        new_params, new_opt, opt_m = ms.update(opt_cfg, params, opt_state,
                                               grads)
        metrics = {k: ms.mean(v.clone(), ms.dp) for k, v in metrics.items()}
        metrics.update(opt_m)
        metrics["loss"] = ms.mean(loss.clone(), ms.dp)
        return new_params, new_opt, metrics

    def mesh_step(params, opt_state, batch):
        with ms.context(batch, ms.dp):
            grads, loss, metrics = grads_of(ms.local(params),
                                            ms.rows(batch, microbatches))
        return finish(params, opt_state, grads, loss, metrics)

    # the step's pieces, for a count of one rank's step by its parts
    # (launch/dryrun.py): the mesh, the local parameters and rows, and the
    # finish
    mesh_step.pieces = dict(mesh_step=ms, local=ms.local, finish=finish)
    return mesh_step


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                               mesh, comp: C.CompressionConfig, *,
                               fsdp: bool = False) -> Callable:
    """The multi-pod step ``step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics)`` on a mesh with a 'pod' axis
    (the reference's assert): each pod's gradient, averaged over its
    'data' ranks, is compressed with its error feedback (``err_state``:
    ``compression.init_error_state`` of the full parameters, on every
    rank) and averaged over the 'pod' group; the loss is the pods' mean,
    and ``metrics["wire_bytes_pod"]`` the bytes one pod sends (a Python
    int). The state is placed as :func:`make_train_step`'s. On a 'model'
    axis of several ranks an error leaf of a 'model'-split gradient holds
    this rank's 'model' block (a whole leaf passed in is cut to it), and
    that gradient is compressed as the whole leaf would be: its int8 scale
    and top-k threshold come from the 'model' group."""
    if mesh is None or "pod" not in Sh.mesh_shape(mesh).axis_names:
        raise ValueError("the compressed step reduces over a 'pod' mesh "
                         "axis: pass a mesh with one")
    grads_of = _grad_fn(get_model(cfg), 1)
    ms = _MeshStep(cfg, mesh, fsdp)
    data = tuple(a for a in ms.dp if a != "pod")

    def pod_step(params, opt_state, err_state, batch):
        with ms.context(batch, data):
            grads, loss, metrics = grads_of(ms.local(params),
                                            ms.rows(batch))
        for g in tree_leaves(grads):
            ms.mean(g, data)
        split = ms.split(grads, params)
        if err_state is not None and any(split):
            err_state = tree_map(ms.model_block, err_state, grads,
                                 ms.shardings["params"])
        grads, new_err, wire = C.compressed_psum_pod(
            comp, grads, err_state, group=mesh.get_group("pod"),
            model_group=ms.mg, split=split)
        new_params, new_opt, opt_m = ms.update(opt_cfg, params, opt_state,
                                               grads)
        metrics = {k: ms.mean(v.clone(), ms.dp) for k, v in metrics.items()}
        metrics.update(opt_m)
        metrics["loss"] = ms.mean(ms.mean(loss.clone(), data), ("pod",))
        metrics["wire_bytes_pod"] = wire
        return new_params, new_opt, new_err, metrics

    return pod_step
