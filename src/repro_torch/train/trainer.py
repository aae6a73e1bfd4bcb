"""The training step on one device (mirrors :mod:`repro.train.trainer`).

A step is the gradient of the model's ``loss_fn`` (``torch.autograd.grad``
in place of ``jax.value_and_grad``), then :func:`repro_torch.optim.adamw.
apply_updates`. Parameters are leaf tensors that require grad; the step
returns new trees, as the reference's does. Microbatches split the batch as
the reference does (microbatch j holds rows j, j + mb, ...), accumulate the
gradients in f32 and report the last microbatch's metrics.

The reference's meshes, FSDP sharding and compressed multi-pod step
(``state_shardings``, ``make_compressed_train_step``) need its
``parallel/sharding.py`` and a mesh, which are not ported: a mesh or
``fsdp`` is refused. The compression itself is
(:mod:`repro_torch.parallel.compression`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.transformer import ModelConfig, get_model
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any


def init_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     seed: int = 0, device=None) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (``None``: the card),
    each requiring grad, and zero moments."""
    params = trainable(get_model(cfg).init(seed, device))
    return TrainState(params, adamw.init_opt_state(opt_cfg, params))


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


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, *, fsdp: bool = False,
                    microbatches: int = 1) -> Callable:
    """The train step ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` on the device of its inputs; ``metrics`` holds
    the loss, the last microbatch's ``ce_loss`` (and ``aux_loss``), the
    gradient norm and the learning rate. The reference's ``donate`` has no
    counterpart: the old trees are freed once the caller drops them."""
    if mesh is not None or fsdp:
        raise NotImplementedError(
            "meshes and FSDP sharding need parallel/sharding.py and "
            "launch/mesh.py, which the port has not got yet; the step runs "
            "on one device")
    grads_of = _grad_fn(get_model(cfg), microbatches)

    def step_fn(params, opt_state, batch):
        grads, loss, metrics = grads_of(params, batch)
        new_params, new_opt, opt_m = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(opt_m)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step_fn


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                               mesh, comp, *, fsdp: bool = False):
    """The reference's multi-pod step with a compressed pod-level
    reduction: not ported. Its compression is
    (:mod:`repro_torch.parallel.compression`); the mesh with a ``pod``
    axis that it runs over is not."""
    raise NotImplementedError(
        "the compressed multi-pod train step needs a mesh with a 'pod' axis "
        "(parallel/sharding.py and launch/mesh.py), which the port has not "
        "got yet; parallel.compression.compressed_psum_pod runs over a "
        "torch.distributed group")
