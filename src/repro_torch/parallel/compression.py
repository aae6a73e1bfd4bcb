"""Gradient compression for the cross-pod reduction (mirrors
:mod:`repro.parallel.compression`): int8 quantization and top-k
sparsification, both with error feedback.

Each leaf is compressed on its own device; :func:`compressed_psum_pod`
then sums the compressed leaves over a ``torch.distributed`` process group
(the reference's ``psum`` over the mesh's ``pod`` axis inside
``shard_map``) and divides by the group's size. The results equal the
reference's bit for bit: ``torch.round`` rounds half to even as
``jnp.round`` does, the top-k threshold is the k-th largest ``|g|``
(``>=`` keeps its ties), and the wire bytes are the same Python integers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | int8 | topk
    topk_ratio: float = 0.05    # fraction of entries kept (kind=topk)
    error_feedback: bool = True


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` correctly rounded, as JAX divides. ``b`` becomes a 0-d
    tensor on a's device: CUDA multiplies by the reciprocal of a Python
    scalar divisor, which can differ from the quotient by an ulp."""
    return a / a.new_full((), b)


def _groups(group) -> tuple:
    """``group`` as a tuple of groups: none, one
    (:class:`~repro_torch.parallel.sharding.AxisGroup`) or several."""
    if group is None:
        return ()
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def quantize_int8(g: torch.Tensor, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale)``: ``scale = max(max |g|, 1e-12) / 127`` (0-d, g's
    dtype), ``q = clip(round(g / scale), -127, 127)``. With ``group`` (an
    :class:`~repro_torch.parallel.sharding.AxisGroup`, or several) ``g`` is
    one block of a leaf split over them, and the max is the whole
    leaf's."""
    amax = g.abs().amax()
    for grp in _groups(group):
        amax = grp.all_reduce(amax, dist.ReduceOp.MAX)
    scale = _div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(g: torch.Tensor, ratio: float, group=None) -> torch.Tensor:
    """1 where ``|g|`` is at least the k-th largest ``|g|`` (``k = max(1,
    int(n * ratio))``; ties with it kept), else 0, in g's dtype. With
    ``group``, as :func:`quantize_int8`'s: ``n`` and the k-th largest are
    the whole leaf's, found among the blocks' own k largest (all-gathered
    over each group in turn, the k largest kept: they hold the leaf's k
    largest)."""
    flat = g.reshape(-1).abs()
    groups = _groups(group)
    k = max(1, int(flat.shape[0] * math.prod(grp.size for grp in groups)
                   * ratio))
    top = torch.topk(flat, min(k, flat.shape[0])).values
    for grp in groups:
        every = grp.all_gather(top, 0)
        top = torch.topk(every, min(k, every.shape[0])).values
    return (g.abs() >= top[k - 1]).to(g.dtype)


def compress_leaf(cfg: CompressionConfig, g: torch.Tensor,
                  err: Optional[torch.Tensor], group=None):
    """``(g_hat in g's dtype, new error (f32) or None, wire bytes)``; with
    ``group``, ``g`` and ``err`` are one block of a leaf split over it,
    compressed as the whole leaf is, and the wire bytes the whole leaf's."""
    g32 = g.to(torch.float32)
    if err is not None and cfg.error_feedback:
        g32 = g32 + err.to(torch.float32)
    n = g.numel() * math.prod(grp.size for grp in _groups(group))
    if cfg.kind == "int8":
        q, s = quantize_int8(g32, group)
        g_hat = dequantize_int8(q, s)
        wire = n * 1 + 4
    elif cfg.kind == "topk":
        g_hat = g32 * topk_mask(g32, cfg.topk_ratio, group)
        wire = int(n * cfg.topk_ratio) * (4 + 4)     # value + index
    else:
        g_hat = g32
        wire = n * 4
    new_err = (g32 - g_hat) if cfg.error_feedback and cfg.kind != "none" \
        else None
    return g_hat.to(g.dtype), new_err, wire


def compressed_psum_pod(cfg: CompressionConfig, grads, err_state,
                        group=None, model_group=None, split=None):
    """Compress each leaf of ``grads`` (with its ``err_state`` leaf), sum
    the compressed leaves over ``group`` and average: ``(avg grads, new
    error tree or None, total wire bytes)``. ``group=None`` is a group of
    one (no collective, n = 1); otherwise ``torch.distributed`` must be
    initialised and every rank of ``group`` calls with the same tree.
    ``split`` (per leaf, in ``tree_leaves`` order: ``True`` for
    ``model_group``, or the groups themselves) marks the leaves that are
    blocks of a leaf split over those groups, compressed as the whole leaf
    (:func:`compress_leaf`)."""
    n = 1 if group is None else dist.get_world_size(group)
    flat_g = tree_leaves(grads)
    flat_e = (tree_leaves(err_state) if err_state is not None
              else [None] * len(flat_g))
    split = split or [False] * len(flat_g)
    out, new_err, wire_total = [], [], 0
    for g, e, sp in zip(flat_g, flat_e, split):
        g_hat, ne, wire = compress_leaf(
            cfg, g, e, model_group if sp is True else (sp or None))
        wire_total += wire
        if group is not None:
            g_hat = g_hat.contiguous()      # NCCL reduces contiguous tensors
            dist.all_reduce(g_hat, group=group)
        out.append(_div(g_hat, n))
        new_err.append(ne)
    err_tree = (tree_unflatten(grads, new_err) if err_state is not None
                else None)
    return tree_unflatten(grads, out), err_tree, wire_total


def init_error_state(cfg: CompressionConfig, params):
    """Zero bf16 error leaves shaped as ``params`` (on their devices), or
    ``None`` when nothing is fed back."""
    if cfg.kind == "none" or not cfg.error_feedback:
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)
