"""Logical-axis -> mesh sharding rules (DP / FSDP / TP / EP / SP) on a
``torch.distributed.device_mesh.DeviceMesh`` (mirrors
:mod:`repro.parallel.sharding`).

Models annotate parameters with logical axes (``init(..., with_axes=
True)``, :mod:`repro_torch.models.common`); this module maps them onto mesh
axes and builds shardings for params, optimizer state, batches and caches.

Default rule set (TP on 'model', DP on 'data' [+ 'pod']):
  heads/kv_heads/mlp/vocab/experts -> 'model'
  embed -> None        (or the DP axes under FSDP)
  layers/head_dim/state/latent -> None

A spec is the reference's ``PartitionSpec`` entries as a tuple, one per
tensor dimension: ``None``, a mesh axis name, or a tuple of names. A
:class:`NamedSharding` is a spec on a mesh; its ``placements`` are the
DTensor placement list, one ``Shard(d)`` or ``Replicate()`` per mesh
dimension. An entry ``('pod', 'data')`` on tensor dim ``d`` is ``Shard(d)``
on both mesh dims: DTensor splits a dim sharded over several mesh dims in
mesh order, the first outermost, which is the row-major order over the
named axes in which ``jax.sharding.NamedSharding`` hands out blocks (a
multi-axis entry must therefore list its axes in mesh order, as
:func:`dp_axes` does).

The rule functions take any mesh with axis names and sizes: a
``DeviceMesh`` (``mesh_dim_names`` and a ``shape`` tuple), an object with
``axis_names`` and a ``shape`` mapping (the reference's ``Mesh``), or a
shape-only :class:`MeshShape`, on which a planner can lay out 256 or 512
chips with no process group.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch.models.common import is_axes_leaf

BASE_RULES: Dict[str, Optional[str]] = {
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
    "head_dim": None,
    "state": None,
    "latent": None,
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, no devices: what the rules read."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of ``mesh``, whatever its kind."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = tuple(getattr(mesh, "axis_names", None)
                  or mesh.mesh_dim_names)
    shape = mesh.shape
    sizes = (tuple(shape[n] for n in names) if isinstance(shape, Mapping)
             else tuple(shape))
    return MeshShape(names, sizes)


def make_rules(fsdp: bool = False,
               data_axes: Sequence[str] = ("data",)) -> Dict[str, Any]:
    rules = dict(BASE_RULES)
    if fsdp:
        rules["embed"] = tuple(data_axes) if len(data_axes) > 1 \
            else data_axes[0]
    return rules


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes used for data parallelism (('pod','data') on multi-pod)."""
    return tuple(a for a in mesh_shape(mesh).axis_names
                 if a in ("pod", "data"))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    shape = mesh_shape(mesh).shape
    if isinstance(name, (tuple, list)):
        return math.prod(shape[n] for n in name)
    return shape[name]


def _dp_entry(dp: Tuple[str, ...]):
    return dp if len(dp) > 1 else dp[0]


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh, rules: Dict[str, Any]) -> Tuple:
    """The spec of one leaf, dropping assignments that don't divide or
    that reuse a mesh axis."""
    entries = []
    used = set()
    for ax_name, dim in zip(axes, shape):
        target = rules.get(ax_name) if ax_name is not None else None
        if target is None:
            entries.append(None)
            continue
        key = tuple(target) if isinstance(target, (list, tuple)) \
            else (target,)
        if set(key) & used or dim % _axis_size(mesh, target) != 0:
            entries.append(None)
            continue
        entries.append(tuple(target) if isinstance(target, (list, tuple))
                       else target)
        used.update(key)
    return tuple(entries)


def placements_for(mesh, spec: Tuple) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``."""
    names = mesh_shape(mesh).axis_names
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        key = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) if n in names else -1 for n in key]
        if -1 in idx or idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {entry!r} is not a run of mesh "
                             f"axes {names} in mesh order")
        for n in key:
            if n in owner:
                raise ValueError(f"mesh axis {n!r} shards two dims of "
                                 f"{spec!r}")
            owner[n] = d
    return [Shard(owner[n]) if n in owner else Replicate() for n in names]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> list:
        return placements_for(self.mesh, self.spec)

    def block(self, shape: Tuple[int, ...], coord: Tuple[int, ...]
              ) -> Tuple[slice, ...]:
        """The block of a ``shape`` tensor held at mesh coordinate
        ``coord``: each dim split evenly over its entry's axes, row-major
        over them."""
        sizes = mesh_shape(self.mesh).shape
        pos = dict(zip(mesh_shape(self.mesh).axis_names, coord))
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            key = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k, i = 1, 0
            for name in key:
                k, i = k * sizes[name], i * sizes[name] + pos[name]
            out.append(slice(i * (n // k), (i + 1) * (n // k)))
        return tuple(out)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and lists, as the
    reference's ``jax.tree_util.tree_map`` sees a cache tree; an axes
    tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not is_axes_leaf(tree):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_shardings(axes_tree, shapes_tree, mesh,
                    rules: Optional[Dict[str, Any]] = None):
    """:class:`NamedSharding` tree for params given logical axes +
    shapes."""
    rules = rules or make_rules()
    return _map(lambda axes, leaf: NamedSharding(
        mesh, spec_for_axes(axes, tuple(leaf.shape), mesh, rules)),
        axes_tree, shapes_tree)


def batch_shardings(batch_tree, mesh):
    """Shard leading (batch) dim over all DP axes."""
    dp = dp_axes(mesh)
    n = math.prod(mesh_shape(mesh).shape[a] for a in dp)

    def one(leaf):
        if leaf.shape[0] % n == 0:
            return NamedSharding(mesh, (_dp_entry(dp),)
                                 + (None,) * (len(leaf.shape) - 1))
        return NamedSharding(mesh, ())

    return _map(one, batch_tree)


def cache_shardings(cache_tree, mesh, *, batch: int, seq: int,
                    head_candidates: Sequence[int] = ()):
    """Heuristic KV/state cache sharding: skip dim0 (layer stack), shard the
    batch dim over DP axes, the sequence dim over 'model'; if no sequence
    dim is present (SSM states), shard a head-like dim over 'model'."""
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh).shape
    dp_size = math.prod(sizes[a] for a in dp)
    tp = sizes["model"]

    def one(leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        used_model = False
        b_dim = next((i for i in range(1, len(shape)) if shape[i] == batch
                      and batch % dp_size == 0), None)
        if b_dim is not None:
            spec[b_dim] = _dp_entry(dp)
        start = (b_dim + 1) if b_dim is not None else 1
        s_dim = next((i for i in range(start, len(shape)) if shape[i] == seq
                      and seq % tp == 0), None)
        if s_dim is not None:
            spec[s_dim] = "model"
            used_model = True
        if not used_model:
            h_dim = next((i for i in range(start, len(shape))
                          if shape[i] in head_candidates
                          and shape[i] % tp == 0), None)
            if h_dim is not None:
                spec[h_dim] = "model"
        return NamedSharding(mesh, tuple(spec))

    return _map(one, cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def distribute(tensor: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``tensor``, the same full value on every rank of ``sharding``'s
    mesh, as a DTensor with its placements: each rank keeps its own block,
    with no communication."""
    return distribute_tensor(tensor, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Activation/cache sharding constraints inside model code.
#
# Models are mesh-agnostic; when a mesh is installed (serving engine),
# attention blocks constrain freshly updated KV caches to (batch -> DP axes,
# sequence -> 'model'). Without one, each helper returns its input.
# ---------------------------------------------------------------------------

_ACT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_mesh", default=None)


class activation_mesh:
    """Context manager installing a mesh for in-model sharding
    constraints."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._tok = _ACT_MESH.set(self.mesh)
        return self

    def __exit__(self, *a):
        _ACT_MESH.reset(self._tok)
        return False


def _constrain(x, mesh, spec: Tuple):
    """A DTensor ``x`` redistributed to ``spec`` on ``mesh``; a plain
    tensor is this rank's whole value and stays as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements_for(mesh, spec))


def constrain_decode_q(q):
    """Sequence-parallel decode attention: replicate the (tiny)
    single-token q across 'model', so it contracts against the
    sequence-sharded KV cache locally. q: [B, 1, H, D]."""
    mesh = _ACT_MESH.get()
    if mesh is None:
        return q
    dp = dp_axes(mesh)
    dpn = math.prod(mesh_shape(mesh).shape[a] for a in dp)
    b_spec = _dp_entry(dp) if q.shape[0] % dpn == 0 else None
    return _constrain(q, mesh, (b_spec, None, None, None))


def maybe_seq_shard_q(q):
    """Context parallelism for attention when the head count does not
    divide the 'model' axis (llama4's 40 heads on a 16-wide axis): shard
    the query sequence over 'model' instead. q: [B, Sq, H, D]."""
    mesh = _ACT_MESH.get()
    if mesh is None:
        return q
    sizes = mesh_shape(mesh).shape
    tp = sizes["model"]
    B, Sq, H, D = q.shape
    if H % tp == 0 or Sq % tp != 0:
        return q
    dp = dp_axes(mesh)
    dpn = math.prod(sizes[a] for a in dp)
    b_spec = _dp_entry(dp) if B % dpn == 0 else None
    return _constrain(q, mesh, (b_spec, "model", None, None))


def constrain_kv_cache(arr):
    """Constrain a cache tensor laid out [B, S, ...] (dims 0=batch,
    1=seq)."""
    mesh = _ACT_MESH.get()
    if mesh is None or arr is None:
        return arr
    sizes = mesh_shape(mesh).shape
    dp = dp_axes(mesh)
    dpn = math.prod(sizes[a] for a in dp)
    spec = [None] * arr.ndim
    if arr.shape[0] % dpn == 0 and dpn > 1:
        spec[0] = _dp_entry(dp)
    if arr.ndim > 1 and arr.shape[1] % sizes["model"] == 0:
        spec[1] = "model"
    return _constrain(arr, mesh, tuple(spec))
