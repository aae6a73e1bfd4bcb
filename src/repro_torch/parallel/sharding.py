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
import weakref
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


def gather_whole(t: DTensor) -> torch.Tensor:
    """The whole value of the DTensor ``t`` on every rank of its mesh, by
    c10d all-gathers of its local block over each mesh dim that shards it
    (the inner dim first: a tensor dim split over several mesh dims nests
    them in mesh order); a replicated ``t`` moves nothing."""
    mesh = t.device_mesh
    x = t.to_local()
    groups = axis_groups(mesh)
    for name, p in reversed(list(zip(mesh.mesh_dim_names, t.placements))):
        if p.is_shard() and groups[name].size > 1:
            x = groups[name].all_gather(x, p.dim)
    return x


def full_tensors(tree):
    """``tree`` with each DTensor leaf gathered whole (:func:`gather_whole`);
    plain leaves stay as they are."""
    return _map(lambda t: gather_whole(t) if isinstance(t, DTensor) else t,
                tree)


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
    this rank's ``index`` among ``count``, in row order, and the
    :class:`AxisGroup` of each of the group's DP axes, outer first, over
    which a per-rank vector is gathered (c10d, the inner axis first: the
    rows nest in mesh order). ``aux``: the load-balance loss, which a train
    step's loss reads, takes the group's expert shares (serving drops
    it)."""
    index: int
    count: int
    axes: Tuple[Any, ...] = ()
    aux: bool = False

    def every(self, x: torch.Tensor) -> torch.Tensor:
        """``[count, *x.shape]``: every rank's ``x``, in row order."""
        out = x[None]
        for g in reversed(self.axes):
            out = g.all_gather(out, 0)
        return out

    def before(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks before this one."""
        return self.every(x)[:self.index].sum(0)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the group's ranks."""
        return self.every(x).mean(0)


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
    groups = axis_groups(mesh, coord)
    return TokenGroup(index, count,
                      tuple(groups[a] for a in ms.axis_names
                            if a in axes and groups[a].size > 1), aux)


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
# leaf), and every layer computes on its blocks. Where 'model' does not
# divide an attention's heads, the query's sequence splits instead
# (:func:`seq_split_group`). The steps install this rank's
# :class:`ModelGroup` (:class:`model_parallel`), and a layer asks
# :func:`layer_group` whether its leaf is such a block: if so it
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

    # The collectives below move values, with no autograd: a differentiable
    # one is an autograd function around them (``_FromModel``, ...).
    @torch.no_grad()
    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced by ``op`` over the group, in a tensor of its own."""
        out = x.detach().contiguous().clone()
        if self.group is None:
            self.calls.append(("all-reduce", out.numel() * out.element_size()))
        else:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    @torch.no_grad()
    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim``, in rank order."""
        dim = dim % x.dim()
        src = x.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        if self.group is None:
            self.calls.append(("all-gather", out.numel() * out.element_size()))
            out.copy_(src.repeat((self.size,) + (1,) * (src.dim() - 1)))
        else:
            dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()

    @torch.no_grad()
    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``x`` summed over the group
        (c10d's reduce-scatter, which ``gloo`` runs on CUDA tensors too)."""
        dim = dim % x.dim()
        src = x.detach().movedim(dim, 0).contiguous()
        blk = self.block(src.shape[0])
        if self.group is None:
            self.calls.append(("reduce-scatter",
                               src.numel() * src.element_size()))
            out = src[blk].clone()
        else:
            out = src.new_empty((blk.stop - blk.start,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()


# the 'model' axis' group, the one the layers split over
ModelGroup = AxisGroup


def axis_groups(mesh, coord=None) -> Dict[str, AxisGroup]:
    """``{axis name: AxisGroup}`` of the rank at ``coord`` (a
    ``DeviceMesh``'s own coordinate unless given), each with its process
    group (none on a :class:`MeshShape`: the collectives are counted)."""
    ms = mesh_shape(mesh)
    if coord is None:
        coord = tuple(mesh.get_coordinate())
    real = hasattr(mesh, "get_group")
    return {n: AxisGroup(coord[i], size, mesh.get_group(n) if real else None)
            for i, (n, size) in enumerate(zip(ms.axis_names, ms.sizes))}


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


def seq_split_group(heads: int, seq: int) -> Optional[ModelGroup]:
    """The installed 'model' group where an attention of ``heads`` query
    heads over ``seq`` query positions splits its queries' sequence (the
    reference's :func:`maybe_seq_shard_q` on the tensor-parallel path: the
    group does not divide the heads, so the layer runs whole, and divides
    ``seq``); ``None`` elsewhere."""
    mg = _MODEL_GROUP.get()
    if mg is None or mg.size == 1 or heads % mg.size == 0 \
            or seq % mg.size != 0:
        return None
    return mg


def _map_paths(fn, tree, prefix=()):
    """``fn(path, leaf)`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def model_dim(spec: Tuple) -> Optional[int]:
    """The tensor dim a spec splits over 'model', if any."""
    return next((d for d, e in enumerate(spec) if e == "model"), None)


def local_params(params, keep, *, shardings=None, shapes=None, group=None):
    """The parameters as a step on a mesh holds them, as plain tensors:
    a DTensor leaf is this rank's block (``to_local()``: over the DP axes
    and 'model', no communication), which :class:`DPGather` gathers over
    the DP axes at its use. A plain leaf is taken as it is unless it is the
    whole leaf (its shape in ``shapes``, a tree of the model's meta
    parameters), ``keep(path)`` (the model's rule: its layer runs in its
    'model' block) and its sharding in ``shardings`` (a tree of
    :class:`NamedSharding`) splits it over 'model': then it is cut to this
    rank's block of ``group`` (:class:`ModelGroup`), a tensor of its
    own."""
    def one(path, t):
        if isinstance(t, DTensor):
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


# ---------------------------------------------------------------------------
# FSDP: a leaf held as this rank's block over the DP axes, gathered at its
# use.
#
# The reference's FSDP rule puts ``embed`` on the DP axes; its layers are a
# ``lax.scan`` over stacked leaves, so GSPMD gathers one block at a time.
# Here a step's parameters are this rank's blocks (over the DP axes and
# 'model') as plain tensors (:func:`local_params`), and the step installs a
# :class:`DPGather` (:class:`dp_gather`) that knows which of them the DP
# axes split. The model reads a leaf through it where it uses it:
#
# - a stacked leaf's block ``i`` in :func:`repro_torch.models.common.layer`
#   (and ``unstack``): the index first, then the gather, so one step of a
#   stage (a block, a super block, a hybrid's group of Mamba blocks) is
#   gathered at a time;
# - an unstacked leaf at its use (:func:`dp_leaf`, :func:`dp_tree`): the
#   embedding (again at a tied head), ``ln_f``, the untied ``lm_head``, the
#   hybrid's shared attention block (at each application), the
#   encoder-decoder's ``ln_enc`` and ``ln_dec``.
#
# The gather all-gathers the block over each DP axis that splits it, the
# inner axis first (the blocks nest in mesh order, as the serving engine's
# row gathers do); its backward reduce-scatters the gradient with a sum
# over the same axes, the outer axis first, so each rank's gradient comes
# back as its block of the DP ranks' sum. Autograd keeps no gathered
# tensor: the gather's saved-tensors hooks replace a saved gathered tensor
# (or a view of one) by its block, and the backward gathers it again
# (``regathers``), so a block gathered for the forward is freed once its
# step ends. Without a gather installed, or where the DP axes do not split
# a leaf, the leaf is read as it is.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPSplit:
    """How a leaf at rest is split over the DP axes: the tensor ``dim`` and
    the :class:`AxisGroup` of each DP mesh dim that splits it, outer first.
    ``outer``: the dim holds that many chunks, one per rank of an outer DP
    axis gathered before (the compressed step's 'pod'), each split over
    ``groups``."""
    dim: int
    groups: Tuple[AxisGroup, ...]
    outer: int = 1

    def _chunks(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(self.dim, (self.outer, -1))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks of ``x`` all-gathered over the groups, the inner
        first (the blocks nest in mesh order)."""
        y = self._chunks(x)
        for g in reversed(self.groups):
            y = g.all_gather(y, self.dim + 1)
        return y.flatten(self.dim, self.dim + 1)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x`` summed over the groups, the outer
        first (the gather's transpose)."""
        y = self._chunks(x)
        for g in self.groups:
            y = g.reduce_scatter(y, self.dim + 1)
        return y.flatten(self.dim, self.dim + 1)

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a gathered ``x`` (no communication)."""
        y = self._chunks(x)
        for g in self.groups:
            y = y[(slice(None),) * (self.dim + 1)
                  + (g.block(y.shape[self.dim + 1]),)]
        return y.flatten(self.dim, self.dim + 1)

    def block(self) -> "DPSplit":
        """The split of one block of a stacked leaf (its first dim indexed
        away)."""
        return dataclasses.replace(self, dim=self.dim - 1)


def dp_split(t: DTensor, axes: Sequence[str],
             groups: Dict[str, AxisGroup], outer: int = 1
             ) -> Optional[DPSplit]:
    """The :class:`DPSplit` of the DTensor ``t`` over the mesh ``axes``
    (those of more than one rank that shard it; ``outer``: as
    :class:`DPSplit`'s), ``None`` where none does."""
    names = t.device_mesh.mesh_dim_names
    split = [(n, p.dim) for n, p in zip(names, t.placements)
             if n in axes and p.is_shard() and groups[n].size > 1]
    if not split:
        return None
    dims = {d for _, d in split}
    if len(dims) != 1:
        raise ValueError(f"the DP axes {axes} shard dims {sorted(dims)} of "
                         "one leaf; a gather takes one")
    return DPSplit(dims.pop(), tuple(groups[n] for n, _ in split), outer)


class _GatherDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, gather, split):
        ctx.gather, ctx.split = gather, split
        return gather._gather(block, split)

    @staticmethod
    def backward(ctx, g):
        return ctx.gather._scatter(g, ctx.split), None, None


@dataclasses.dataclass
class _Gathered:
    """A gathered tensor, weakly, and the block and split it was gathered
    from (what a saved-tensor hook keeps in its place)."""
    block: torch.Tensor
    split: DPSplit
    ref: Any


class DPGather:
    """The DP gather of one step (the section above: where the model reads
    its leaves through it, stacked and unstacked): which leaves the DP axes
    split (:meth:`register`), and its counts: ``gathers`` (the forward's),
    ``regathers`` (the backward's: in place of a saved gathered tensor, and
    a remat's recompute), ``reduce_scatters`` (the gradients'), the bytes of
    each (``gathered_bytes``, ``regathered_bytes``, ``scattered_bytes``:
    the gathered tensors'), ``live_bytes`` (the gathered tensors alive
    now) and ``high_bytes`` (their most at once since :meth:`reset`)."""

    def __init__(self):
        self.splits: Dict[int, Tuple[torch.Tensor, DPSplit]] = {}
        self._live: Dict[int, _Gathered] = {}
        self.live_bytes = 0
        self.reset()

    def reset(self) -> None:
        """The counts back to 0, the high-water mark to the live bytes."""
        self.gathers = self.regathers = self.reduce_scatters = 0
        self.gathered_bytes = self.regathered_bytes = 0
        self.scattered_bytes = 0
        self.high_bytes = self.live_bytes

    def counts(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in (
            "gathers", "regathers", "reduce_scatters", "gathered_bytes",
            "regathered_bytes", "scattered_bytes", "high_bytes")}

    # ---------------- the leaves
    def register(self, placed, local, axes: Sequence[str], mesh,
                 outer=None) -> None:
        """Forgets the leaves registered before, then registers each leaf
        of ``local`` (the blocks the step computes on) that the mesh
        ``axes`` split in its DTensor twin in ``placed`` (``outer(t)``: the
        :class:`DPSplit`'s ``outer`` of the DTensor ``t``, 1 unless
        given)."""
        self.splits = {}
        groups = axis_groups(mesh)

        def one(t, leaf):
            s = dp_split(t, axes, groups, outer(t) if outer else 1) \
                if isinstance(t, DTensor) else None
            if s is not None:
                self.splits[id(leaf)] = (leaf, s)
            return leaf

        _map(one, placed, local)

    def forget(self) -> None:
        """Forgets the registered leaves (the step's blocks, which it would
        otherwise keep alive)."""
        self.splits = {}

    def split_of(self, t) -> Optional[DPSplit]:
        e = self.splits.get(id(t))
        return e[1] if e is not None and e[0] is t else None

    def alias(self, view: torch.Tensor, stacked: torch.Tensor) -> None:
        """Registers ``view``, one block of the stacked leaf ``stacked``
        (its first dim indexed away), as split where ``stacked`` is."""
        s = self.split_of(stacked)
        if s is not None:
            self.splits[id(view)] = (view, s.block())

    def take(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i`` of the stacked leaf ``t``, gathered where the DP axes
        split it."""
        s = self.split_of(t)
        return t[i] if s is None else self.gather(t[i], s.block())

    def leaf(self, t: torch.Tensor) -> torch.Tensor:
        """The leaf ``t``, gathered where the DP axes split it."""
        s = self.split_of(t)
        return t if s is None else self.gather(t, s)

    # ---------------- the collectives
    def gather(self, block: torch.Tensor, split: DPSplit) -> torch.Tensor:
        if block.requires_grad and torch.is_grad_enabled():
            return _GatherDP.apply(block, self, split)
        return self._gather(block, split)

    def _gather(self, block, split, again: bool = False) -> torch.Tensor:
        """``split.gather(block)``, counted; the tensor that holds its
        storage (the root of its views) is tracked until it is freed."""
        with torch.no_grad():
            out = split.gather(block)
        root = out if out._base is None else out._base
        n = root.numel() * root.element_size()
        # a gather while autograd runs a backward (a remat's recompute) is
        # the backward's too
        again = again or torch._C._current_graph_task_id() != -1
        if again:
            self.regathers += 1
            self.regathered_bytes += n
        else:
            self.gathers += 1
            self.gathered_bytes += n
            self._live[id(root)] = _Gathered(block, split, weakref.ref(root))
        self.live_bytes += n
        self.high_bytes = max(self.high_bytes, self.live_bytes)
        weakref.finalize(root, self._release, id(root), n, again)
        return out

    def _release(self, key: int, n: int, again: bool) -> None:
        self.live_bytes -= n
        if not again:
            self._live.pop(key, None)

    def _scatter(self, g: torch.Tensor, split: DPSplit) -> torch.Tensor:
        self.reduce_scatters += 1
        self.scattered_bytes += g.numel() * g.element_size()
        return split.scatter(g)

    # ---------------- the saved-tensors hooks
    def pack(self, t: torch.Tensor):
        """A saved tensor, or in place of a gathered tensor (or a view of
        one) its block and the view's geometry."""
        root = t if t._base is None else t._base
        h = self._live.get(id(root))
        if h is None or h.ref() is not root:
            return t
        return (h, tuple(t.size()), tuple(t.stride()), t.storage_offset())

    def unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        h, size, stride, offset = saved
        root = h.ref()
        if root is None:
            out = self._gather(h.block, h.split, again=True)
            root = out if out._base is None else out._base
            h.ref = weakref.ref(root)
        return root.as_strided(size, stride, offset)


_DP_GATHER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dp_gather", default=None)


class dp_gather:
    """Context manager installing a :class:`DPGather` (``None``: none) for
    the model's reads of its leaves, with its saved-tensors hooks."""

    def __init__(self, gather: Optional[DPGather]):
        self.gather = gather

    def __enter__(self):
        self._tok = _DP_GATHER.set(self.gather)
        self._hooks = None
        if self.gather is not None:
            self._hooks = torch.autograd.graph.saved_tensors_hooks(
                self.gather.pack, self.gather.unpack)
            self._hooks.__enter__()
        return self

    def __exit__(self, *a):
        if self._hooks is not None:
            self._hooks.__exit__(*a)
        _DP_GATHER.reset(self._tok)
        return False


def current_dp_gather() -> Optional[DPGather]:
    return _DP_GATHER.get()


def dp_leaf(t: torch.Tensor) -> torch.Tensor:
    """An unstacked leaf as the model uses it: gathered over the DP axes
    where the installed :class:`DPGather` says they split it, else
    ``t``."""
    g = _DP_GATHER.get()
    return t if g is None else g.leaf(t)


def dp_tree(tree):
    """:func:`dp_leaf` over the leaves of a dict tree."""
    g = _DP_GATHER.get()
    return tree if g is None else _map(g.leaf, tree)
