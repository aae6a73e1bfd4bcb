"""Training step builders (mirrors :mod:`repro.train.trainer`): the step
on one device, the sharded step on a mesh (DP, FSDP, TP and EP) and the
multi-pod step with a compressed pod-level reduction.

A step is the gradient of the model's ``loss_fn`` (``torch.autograd.grad``
in place of ``jax.value_and_grad``), then :func:`repro_torch.optim.adamw.
apply_updates`. Parameters are leaf tensors that require grad; the step
returns new trees, as the reference's does. Microbatches split the batch as
the reference does (microbatch j holds rows j, j + mb, ...), accumulate the
gradients in f32 and report the last microbatch's metrics.

On a mesh (a ``DeviceMesh``, :mod:`repro_torch.launch.mesh`) the state at
rest is DTensors placed by :func:`state_shardings`: 'model' splits the
heads, MLP, vocabulary and experts (the reference's rules; where 'model'
divides neither the heads nor the experts, the query's sequence and each
expert's width), and under FSDP the DP axes split every ``embed`` dim, so
each rank holds ``1/(data*model)`` of most leaves. The parameters are dict
trees, not ``nn.Module``s, so the sharded step is written in plain
``torch.distributed`` (c10d; no DTensor collective):

1. the forward and backward run on this rank's blocks of the parameters as
   plain tensors (``DTensor.to_local``, which moves nothing;
   :func:`~repro_torch.parallel.sharding.local_params`): every leaf the
   reference's rules split over 'model' stays in its 'model' block, and
   its layer computes its share on it (GQA, MLA and cross-attention heads,
   the encoder, the MLPs, the vocabulary, the experts or their width, the
   Mamba mixer and the xLSTM cells), combining the shares over 'model'
   through explicit collectives (Megatron's ``to_model`` /
   ``from_model``);
2. a block the DP axes split (FSDP) is gathered over them where the model
   reads it, one step of a stage at a time, by the step's
   :class:`~repro_torch.parallel.sharding.DPGather`: c10d all-gathers, the
   inner axis first; autograd keeps no gathered tensor (the backward
   gathers a block again) and the gradient comes back reduce-scattered,
   this rank's block of the DP ranks' sum;
3. the rows are this rank's rows of the batch (sharded over the DP axes as
   :func:`~repro_torch.parallel.sharding.batch_shardings` says; a DTensor
   batch is taken as its local rows, or gathered over c10d);
4. the gradients become the global batch's mean: a reduce-scattered one is
   divided by the DP size, any other all-reduced over the DP axes first;
5. they are clipped by the whole gradient's norm, as ``apply_updates``
   does (each leaf's sum of squares all-reduced over every axis that
   splits it, each element counted once), and
6. this rank's blocks of the parameters and moments are updated.

A MoE layer routes the global batch, as the reference's global program
does (:class:`~repro_torch.parallel.sharding.TokenGroup`; the compressed
step: each pod's batch). On a mesh whose 'model' axis has one rank nothing
is split over it, without FSDP nothing is gathered over the DP axes, and on
a mesh of one rank the step is the one-device step's, bit for bit. The
compressed step (:func:`make_compressed_train_step`) takes each leaf whole
over 'pod' first, as the reference's ``shard_map`` does, gathers over
'data' at its use, averages each pod's gradient over its 'data' ranks and
runs it through :func:`~repro_torch.parallel.compression.
compressed_psum_pod` over the mesh's 'pod' group, each gradient block
compressed as its whole leaf (the int8 scale and the top-k threshold come
from every group that holds a block of it).
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
from repro_torch.models.transformer import ModelConfig, get_model
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


def _merged(a, b, sizes) -> bool:
    """Whether two DTensor placement lists place the same blocks: they
    differ only on mesh dims of one rank."""
    return all(p == q or n == 1 for p, q, n in zip(a, b, sizes))


class _MeshStep:
    """What a sharded step needs of its mesh: this rank's coordinate, the
    DP axes, the axes' groups, its 'model' group and the step's
    :class:`~repro_torch.parallel.sharding.DPGather` over ``gather_axes``
    (the DP axes unless given). ``eager``: DP axes over which
    :meth:`local` gathers a leaf before the step (the compressed step's
    'pod'; the gather at use then takes the chunks it made)."""

    def __init__(self, cfg, mesh, fsdp: bool, gather_axes=None, eager=()):
        self.mesh = mesh
        self.shardings = state_shardings(cfg, mesh, fsdp=fsdp)
        self.coord = tuple(mesh.get_coordinate())
        self.dp = Sh.dp_axes(mesh)
        self.sizes = Sh.mesh_shape(mesh).shape
        self.groups = Sh.axis_groups(mesh, self.coord)
        self.mg = Sh.model_group_of(mesh, self.coord)
        self.gather = Sh.DPGather()
        self.gather_axes = self.dp if gather_axes is None else gather_axes
        self.eager = tuple(eager)

    def split_axes(self, t: DTensor) -> list:
        """The mesh axes of more than one rank that shard the DTensor
        ``t``, in mesh order."""
        return [n for n, p in zip(self.mesh.mesh_dim_names, t.placements)
                if p.is_shard() and self.sizes[n] > 1]

    def local(self, params):
        """The parameters the forward and backward run on, as leaves that
        require grad: this rank's blocks (``DTensor.to_local()``, no
        communication), each gathered first over the ``eager`` axes that
        split it; the step's ``gather`` registers those the gather axes
        split, and gathers them where the model reads them (installed by
        :meth:`context`)."""
        def one(t):
            x = (t.to_local() if isinstance(t, DTensor) else t).detach()
            s = Sh.dp_split(t, self.eager, self.groups) if self.eager \
                else None
            if s is not None:
                with torch.no_grad():
                    x = s.gather(x)
            return x.requires_grad_()

        blocks = tree_map(one, params)
        self.gather.register(params, blocks, self.gather_axes, self.mesh,
                             outer=self.outer)
        return blocks

    def outer(self, t: DTensor) -> int:
        """The chunks an ``eager`` gather leaves in the dim it gathers."""
        return math.prod(self.sizes[n] for n in self.split_axes(t)
                         if n in self.eager)

    def context(self, batch, axes):
        """The step's groups: the MoE routing's over the DP ``axes``, this
        rank's 'model' group and the step's DP gather."""
        stack = contextlib.ExitStack()
        stack.enter_context(Sh.token_group(self.group(batch, axes)))
        stack.enter_context(Sh.model_parallel(self.mg))
        stack.enter_context(Sh.dp_gather(self.gather))
        return stack

    def rows(self, batch, microbatches: int = 1):
        """This rank's rows of each leaf of ``batch``, as
        ``batch_shardings`` places them: of a plain leaf (the global batch,
        on every rank) by slicing; of a DTensor leaf its local block where
        it already holds those rows, else its whole value gathered over
        c10d, then sliced."""
        sh = Sh.batch_shardings(batch, self.mesh)
        sizes = Sh.mesh_shape(self.mesh).sizes
        out = {}
        for k, v in batch.items():
            if isinstance(v, DTensor):
                if _merged(v.placements, sh[k].placements, sizes):
                    out[k] = v.to_local()
                    continue
                v = Sh.gather_whole(v)
            out[k] = v[sh[k].block(tuple(v.shape), self.coord)]
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

    def average(self, grads, params, axes) -> None:
        """The gradients, summed over the DP ``axes``' ranks' rows, as
        their mean, in place: a leaf the axes split came back
        reduce-scattered (this rank's block of the sum) and is divided; any
        other is all-reduced over the axes first (:meth:`mean`)."""
        n = math.prod(self.sizes[a] for a in axes)
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            if set(self.split_axes(p)) & set(axes):
                g.div_(n)
            else:
                self.mean(g, axes)

    def global_norm(self, grads, params) -> torch.Tensor:
        """The norm of the whole gradient, each element counted once: each
        leaf's sum of squares all-reduced over every mesh axis that splits
        it (one call per axis, the leaves it splits stacked), added in the
        leaves' order (``adamw.global_norm``'s)."""
        axes = [self.split_axes(p) for p in tree_leaves(params)]
        if not any(axes):
            return adamw.global_norm(grads)
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
        for a in self.mesh.mesh_dim_names:
            idx = [i for i, ax in enumerate(axes) if a in ax]
            if idx:
                summed = self.groups[a].all_reduce(
                    torch.stack([sq[i] for i in idx]))
                for j, i in enumerate(idx):
                    sq[i] = summed[j]
        return torch.sqrt(sum(sq))

    def block(self, t, sharding) -> torch.Tensor:
        """This rank's block of a whole leaf ``t`` placed by ``sharding``
        (a :class:`~repro_torch.parallel.sharding.NamedSharding`)."""
        return t[sharding.block(tuple(t.shape), self.coord)]

    def update(self, opt_cfg, params, opt_state, grads):
        """This rank's shards of the parameters and moments updated by the
        averaged ``grads`` (this rank's blocks), clipped by the whole
        gradient's norm, as DTensors."""
        gnorm = self.global_norm(grads, params)
        local = lambda t: t.to_local()
        new_p, new_opt, opt_m = adamw.apply_updates(
            opt_cfg, tree_map(local, params), grads,
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
        """Steps (4)-(6) of the module docstring, and the metrics' means."""
        ms.average(grads, params, ms.dp)
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
        ms.gather.forget()
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
    'data' ranks, is compressed with its error feedback and averaged over
    the 'pod' group; the loss is the pods' mean, and
    ``metrics["wire_bytes_pod"]`` the bytes one pod sends (a Python int).
    The state is placed as :func:`make_train_step`'s.

    As the reference's ``shard_map`` over 'pod' takes the parameters whole
    over 'pod', a leaf split over ('pod', 'data') is gathered over 'pod'
    first (its pod chunks, each this rank's 'data' block), then gathered
    over 'data' at its use, and its gradient comes back reduce-scattered
    over 'data': each pod chunk's 'data' block, summed over the pod's
    ranks. A gradient is compressed in that layout, this rank's block over
    'data' and 'model' of its pod's gradient, as the whole leaf would be
    (the int8 scale and the top-k threshold come from the 'data' and
    'model' groups that hold its other blocks), then summed over 'pod' and
    cut to this rank's pod chunk. An ``err_state`` leaf
    (``compression.init_error_state``) is held in the same layout: a whole
    leaf passed in is cut to it."""
    if mesh is None or "pod" not in Sh.mesh_shape(mesh).axis_names:
        raise ValueError("the compressed step reduces over a 'pod' mesh "
                         "axis: pass a mesh with one")
    grads_of = _grad_fn(get_model(cfg), 1)
    data = tuple(a for a in Sh.dp_axes(mesh) if a != "pod")
    ms = _MeshStep(cfg, mesh, fsdp, gather_axes=data, eager=("pod",))

    def held(p) -> tuple:
        """The groups holding the other blocks of a gradient of ``p`` as
        the step compresses it (every axis that splits it but 'pod')."""
        return tuple(ms.groups[a] for a in ms.split_axes(p) if a != "pod")

    def comp_block(t, p, sharding):
        """A whole leaf ``t`` of ``p``'s shape (placed by ``sharding``) in
        the compression layout (this rank's 'model' block, and its 'data'
        block of each pod chunk); any other ``t`` as it is."""
        if tuple(t.shape) != tuple(p.shape):
            return t
        d = Sh.model_dim(sharding.spec)
        if d is not None and ms.mg is not None:
            t = t[(slice(None),) * d + (ms.mg.block(t.shape[d]),)]
        s = Sh.dp_split(p, data, ms.groups, ms.outer(p))
        return t if s is None else s.cut(t)

    def pod_cut(g, p):
        """This rank's pod chunk of a gradient in the compression
        layout."""
        s = Sh.dp_split(p, ("pod",), ms.groups)
        return g if s is None else s.cut(g)

    def pod_step(params, opt_state, err_state, batch):
        with ms.context(batch, data):
            grads, loss, metrics = grads_of(ms.local(params),
                                            ms.rows(batch))
        ms.gather.forget()
        ms.average(grads, params, data)
        if err_state is not None:
            err_state = tree_map(comp_block, err_state, params,
                                 ms.shardings["params"])
        grads, new_err, wire = C.compressed_psum_pod(
            comp, grads, err_state, group=mesh.get_group("pod"),
            split=[held(p) for p in tree_leaves(params)])
        new_params, new_opt, opt_m = ms.update(
            opt_cfg, params, opt_state, tree_map(pod_cut, grads, params))
        metrics = {k: ms.mean(v.clone(), ms.dp) for k, v in metrics.items()}
        metrics.update(opt_m)
        metrics["loss"] = ms.mean(ms.mean(loss.clone(), data), ("pod",))
        metrics["wire_bytes_pod"] = wire
        return new_params, new_opt, new_err, metrics

    return pod_step
