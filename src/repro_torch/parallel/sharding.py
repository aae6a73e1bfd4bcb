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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor


def is_axes_leaf(x) -> bool:
    """A logical axes leaf: a tuple of axis names (or ``None``)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)

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


def full_tensors(tree):
    """``tree`` with each DTensor leaf gathered whole (``full_tensor``);
    plain leaves stay as they are."""
    return _map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                tree)


def from_block(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """This rank's block ``t`` of a contiguous ``shape`` tensor placed by
    ``placements`` on ``mesh``, as a DTensor (no communication)."""
    shape = tuple(shape)
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


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
    """The DTensor ``x`` redistributed to ``spec`` on ``mesh`` (the helpers
    below return a plain tensor, this rank's whole value, as it is)."""
    return x.redistribute(mesh, placements_for(mesh, spec))


def constrain_decode_q(q):
    """Sequence-parallel decode attention: replicate the (tiny)
    single-token q across 'model', so it contracts against the
    sequence-sharded KV cache locally. q: [B, 1, H, D]."""
    mesh = _ACT_MESH.get()
    if mesh is None or not isinstance(q, DTensor):
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
    if mesh is None or not isinstance(q, DTensor):
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
    if mesh is None or not isinstance(arr, DTensor):
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


# ---------------------------------------------------------------------------
# One rank's block of the sequence-sharded caches, and the combine of a
# decode attention computed in blocks.
#
# The reference shards a decode cache's sequence over 'model' and lets XLA
# turn the softmax over the sharded length into an all-reduce. Here each
# rank holds positions [start, stop) of every sequence-sharded leaf as a
# plain tensor: the serving engine installs a :class:`CacheBlock`, the
# attention writes only the new entries that fall in the block, attends
# over the block, and joins the blocks' partial softmaxes across 'model'
# (:func:`combine_across`; :func:`combine_blocks` is the same over a list,
# on one device). Without a block installed the attention is the meshless
# one.
# ---------------------------------------------------------------------------

NEG = -1e30        # the attention's mask value (models/attention.py's)


@dataclasses.dataclass(frozen=True)
class CacheBlock:
    """This rank's positions ``[start, stop)`` on the sequence dim of every
    sequence-sharded cache leaf (the block that ``cache_shardings``'
    'model' entry gives it), and the 'model' process group whose ranks
    hold the other blocks of the same rows."""
    start: int
    stop: int
    group: Any = None

    def write(self, dst: torch.Tensor, src: torch.Tensor, pos: int) -> None:
        """Write the new entries ``src [B, S, ...]``, at global positions
        ``[pos, pos + S)``, into this rank's block ``dst [B, stop - start,
        ...]``, in place: only those that fall in ``[start, stop)``."""
        a = max(pos, self.start)
        b = min(pos + src.shape[1], self.stop)
        if a < b:
            dst[:, a - self.start:b - self.start] = \
                src[:, a - pos:b - pos].to(dst.dtype)

    def local_valid(self, kv_valid_len: torch.Tensor) -> torch.Tensor:
        """``[B]`` valid entries of this block, ``clamp(valid - start, 0,
        stop - start)``, of ``kv_valid_len`` valid global entries."""
        return (kv_valid_len - self.start).clamp(0, self.stop - self.start)

    def combine(self, m, l, o) -> torch.Tensor:
        """This rank's partial softmax joined with the other blocks' over
        the 'model' group (:func:`combine_across`)."""
        return combine_across(m, l, o, self.group)


_CACHE_BLOCK: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cache_block", default=None)


class cache_block:
    """Context manager installing a :class:`CacheBlock` (``None``: none)
    for the attention's cache writes and decode."""

    def __init__(self, block: Optional[CacheBlock]):
        self.block = block

    def __enter__(self):
        self._tok = _CACHE_BLOCK.set(self.block)
        return self

    def __exit__(self, *a):
        _CACHE_BLOCK.reset(self._tok)
        return False


def current_cache_block() -> Optional[CacheBlock]:
    return _CACHE_BLOCK.get()


def block_softmax(scores: torch.Tensor, ok: torch.Tensor):
    """One block's partial softmax over its last dim: ``(m, l, p)`` with
    ``m`` the largest valid score, ``p = exp(scores - m)`` (zero where
    ``ok``, broadcast to ``scores``, is false) and ``l`` its sum. A block
    with no valid entry gives ``m = NEG``, ``l = 0`` and ``p = 0``."""
    s = scores.masked_fill(~ok, NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(~ok, 0.0)
    return m, p.sum(-1), p


def combine_blocks(parts: List[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]) -> torch.Tensor:
    """The attention of blocks ``[(m, l, o), ...]`` (``m``, ``l`` of one
    shape, ``o`` of it and a value dim; ``o = p @ v`` of the block's
    :func:`block_softmax`), on one device: each block rescaled by ``exp(m
    - max m)``, then ``sum o / sum l``. A block with no valid entry adds
    zero."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = o = 0
    for mi, li, oi in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        o = o + oi * w[..., None]
    return o / l[..., None]


def combine_across(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   group) -> torch.Tensor:
    """:func:`combine_blocks` over the ranks of ``group``, each holding one
    block: an all-reduce ``MAX`` of ``m``, the rescale by ``exp(m_local -
    m)``, and one all-reduce ``SUM`` of ``l`` and ``o`` side by side."""
    mg = m.contiguous().clone()
    dist.all_reduce(mg, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - mg)
    lo = torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1)
    dist.all_reduce(lo, group=group)
    return lo[..., 1:] / lo[..., :1]


@dataclasses.dataclass(frozen=True)
class TokenGroup:
    """The DP ranks whose rows make one batch (the MoE routing's group):
    this rank's ``index`` among ``count``, in row order, and the mesh and
    placements (``Shard(0)`` on the group's DP axes) over which a per-rank
    vector is gathered. ``aux``: the load-balance loss, which a train
    step's loss reads, takes the group's expert shares (serving drops
    it)."""
    index: int
    count: int
    mesh: Any
    placements: Any
    aux: bool = False

    def before(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks before this one."""
        every = from_block(x[None], self.mesh, self.placements,
                           (self.count,) + tuple(x.shape)).full_tensor()
        return every[:self.index].sum(0)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the group's ranks."""
        return from_block(x[None], self.mesh, self.placements,
                          (self.count,) + tuple(x.shape)).full_tensor().mean(0)


def token_group_of(mesh, coord, axes: Sequence[str], *,
                   aux: bool = False) -> Optional[TokenGroup]:
    """The :class:`TokenGroup` of the rank at ``coord`` over the DP
    ``axes`` (their rows make one batch), ``None`` when they are one
    rank."""
    ms = mesh_shape(mesh)
    sizes = ms.shape
    count = math.prod(sizes[a] for a in axes)
    if count == 1:
        return None
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[ms.axis_names.index(a)]
    return TokenGroup(index, count, mesh,
                      [Shard(0) if n in axes else Replicate()
                       for n in ms.axis_names], aux)


_TOKEN_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_token_group", default=None)


class token_group:
    """Context manager installing a :class:`TokenGroup` (``None``:
    none)."""

    def __init__(self, group: Optional[TokenGroup]):
        self.group = group

    def __enter__(self):
        self._tok = _TOKEN_GROUP.set(self.group)
        return self

    def __exit__(self, *a):
        _TOKEN_GROUP.reset(self._tok)
        return False


def current_token_group() -> Optional[TokenGroup]:
    return _TOKEN_GROUP.get()


# ---------------------------------------------------------------------------
# Tensor and expert parallelism on 'model'.
#
# The reference shards the heads, MLP, vocabulary and experts over 'model'
# and lets GSPMD run each product on the device's shard. Here a leaf whose
# spec puts 'model' on a dim stays in its 'model' block on its rank, at rest
# and in every step (:func:`local_params`, told which by the one rule of
# :func:`repro_torch.models.transformer.model_parallel_leaf`: every such
# leaf but a routed expert's mlp dim), and every layer computes on its
# blocks. The steps
# install this rank's :class:`ModelGroup` (:class:`model_parallel`), and a
# layer asks :func:`layer_group` whether its leaf is such a block: if so it
# computes its share and combines the shares through explicit collectives
# over the group, in Megatron's form: :func:`to_model` before a
# column-parallel product (identity forward, the gradient all-reduced
# backward), :func:`from_model` after a row-parallel one (all-reduced
# forward, identity backward) and :func:`gather_model` where a block is
# joined whole (all-gathered forward, this rank's block backward); if its
# leaf is whole it runs whole. With no group installed, or a 'model' axis
# of one rank, every layer is the meshless one.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AxisGroup:
    """This rank's ``index`` among the ``size`` ranks of one mesh axis, and
    their process group: the 'model' axis for the layers (:data:`ModelGroup`),
    each axis for the serving engine's cache and row moves. With
    ``group=None`` (a :class:`MeshShape`: a planner's layout) the
    collectives move nothing and are counted in ``calls``, ``(kind,
    bytes)`` each."""
    index: int
    size: int
    group: Any = None
    calls: list = dataclasses.field(default_factory=list)

    def splits(self, n: int) -> bool:
        """Whether the reference's rule splits a dim of ``n`` over 'model':
        the axis has more than one rank and divides ``n``."""
        return self.size > 1 and n % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of a dim of ``n`` that 'model' splits."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced by ``op`` over the group, in a tensor of its own."""
        out = x.contiguous().clone()
        if self.group is None:
            self.calls.append(("all-reduce", out.numel() * out.element_size()))
        else:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim``, in rank order."""
        dim = dim % x.dim()
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        if self.group is None:
            self.calls.append(("all-gather", out.numel() * out.element_size()))
            out.copy_(src.repeat((self.size,) + (1,) * (src.dim() - 1)))
        else:
            dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()


# the 'model' axis' group, the one the layers split over
ModelGroup = AxisGroup


def model_group_of(mesh, coord=None) -> Optional[ModelGroup]:
    """The :class:`ModelGroup` of the rank at ``coord`` (a ``DeviceMesh``'s
    own coordinate unless given; a :class:`MeshShape` needs it), ``None``
    where the mesh has no 'model' axis of more than one rank."""
    ms = mesh_shape(mesh)
    size = ms.shape.get("model", 1)
    if size == 1:
        return None
    if coord is None:
        coord = tuple(mesh.get_coordinate())
    group = mesh.get_group("model") if hasattr(mesh, "get_group") else None
    return ModelGroup(coord[ms.axis_names.index("model")], size, group)


_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_model_group", default=None)


class model_parallel:
    """Context manager installing a :class:`ModelGroup` (``None``: none, so
    the layers inside run whole) for the layers' tensor and expert
    parallelism."""

    def __init__(self, group: Optional[ModelGroup]):
        self.group = group

    def __enter__(self):
        self._tok = _MODEL_GROUP.set(self.group)
        return self

    def __exit__(self, *a):
        _MODEL_GROUP.reset(self._tok)
        return False


def layer_group(local: int, n: int) -> Optional[ModelGroup]:
    """The installed 'model' group where a layer's leaf holds ``local``
    entries of a dim of ``n``, this rank's block of it (the layer then
    computes its share); ``None`` where the leaf holds the whole dim (the
    layer runs whole). Raises ``ValueError`` where it is neither."""
    if local == n:
        return None
    mg = _MODEL_GROUP.get()
    if mg is None or not mg.splits(n) or local * mg.size != n:
        size = None if mg is None else mg.size
        raise ValueError(f"a leaf's dim of {local} is neither the whole "
                         f"{n} nor this rank's 'model' block of it (the "
                         f"installed group's size: {size})")
    return mg


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.all_reduce(g), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return mg.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim % x.dim()
        return mg.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        return g[(slice(None),) * d + (ctx.mg.block(g.shape[d]),)], None, None


def gather_model(x: torch.Tensor, mg: Optional[ModelGroup],
                 dim: int) -> torch.Tensor:
    """Every rank's block ``x`` of a dim that 'model' splits, joined whole
    along ``dim`` in rank order (the same on every rank of ``mg``): an
    all-gather forward, this rank's block of the gradient backward (every
    rank continues from the same whole value, so each holds the whole
    gradient; where a 'model'-parallel part follows, :func:`to_model` sums
    it first); ``x`` itself where ``mg`` is ``None``."""
    return x if mg is None else _GatherModel.apply(x, mg, dim)


def local_count(n: int) -> int:
    """The share of a layer's ``n`` heads that this rank computes on:
    ``n / size`` where the installed 'model' group splits ``n`` (the
    reference's rule puts the heads on 'model' there), else ``n``. The
    caches of head-split layers are built at this count."""
    mg = _MODEL_GROUP.get()
    return n // mg.size if mg is not None and mg.splits(n) else n


def to_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """``x`` (the same on every rank of ``mg``) entering a 'model'-parallel
    product: itself forward, its gradient summed over ``mg`` backward (each
    rank's share of the product gives a share of it); ``x`` itself where
    ``mg`` is ``None``."""
    return x if mg is None else _ToModel.apply(x, mg)


def from_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """This rank's share ``x`` of a 'model'-parallel product, summed over
    ``mg`` (the gradient passes through unchanged: every rank continues
    from the same sum); ``x`` itself where ``mg`` is ``None``."""
    return x if mg is None else _FromModel.apply(x, mg)


def _map_paths(fn, tree, prefix=()):
    """``fn(path, leaf)`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def model_dim(spec: Tuple) -> Optional[int]:
    """The tensor dim a spec splits over 'model', if any."""
    return next((d for d, e in enumerate(spec) if e == "model"), None)


def local_params(params, keep, *, shardings=None, shapes=None, group=None):
    """The parameters as a step on a mesh computes on them, as plain
    tensors. ``keep(path)``: whether the leaf at ``path`` (its keys) runs in
    its 'model' block or whole (the model's rule).

    A DTensor leaf is gathered over its DP/FSDP mesh dims and, unless
    ``keep(path)``, over 'model' too (one gather per leaf). A plain leaf is
    taken as it is unless it is the whole leaf (its shape in ``shapes``, a
    tree of the model's meta
    parameters), ``keep(path)`` and its sharding in ``shardings`` (a tree
    of :class:`NamedSharding`) splits it over 'model': then it is cut to
    this rank's block of ``group`` (:class:`ModelGroup`), a tensor of its
    own."""
    def one(path, t):
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            kept = keep(path)
            pl = [p if (n == "model" and kept and p.is_shard())
                  else Replicate()
                  for n, p in zip(mesh.mesh_dim_names, t.placements)]
            if list(t.placements) != pl:
                t = t.redistribute(mesh, pl)
            return t.to_local()
        if group is None or shardings is None or not keep(path):
            return t
        sh, whole = shardings, shapes
        for k in path:
            sh, whole = sh[k], whole[k]
        d = model_dim(sh.spec)
        if d is None or tuple(t.shape) != tuple(whole.shape):
            return t
        return t[(slice(None),) * d + (group.block(t.shape[d]),)].clone()

    return _map_paths(one, params)
