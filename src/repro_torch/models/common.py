"""Shared model components (mirrors :mod:`repro.models.common`): the
parameter builder, RMS and layer norms, RoPE, the SwiGLU and gelu MLPs,
the LM head and the cross-entropy loss.

Parameters are nested dicts of tensors with the reference's layouts
(stacked ``[L, ...]`` leaves for repeated blocks, ``wq [D, H, Dh]``, ...),
so a reference parameter tree converts by copying
(:mod:`repro_torch.models.weights`).

Every ``init_*`` returns ``(params, axes)``, as the reference's does:
``axes`` mirrors the parameter tree with a tuple of *logical* axis names
per dimension, which :mod:`repro_torch.parallel.sharding` maps onto a
mesh, so models never mention the mesh. The vocabulary is the
reference's: ``"layers"`` (stacked blocks, never sharded), ``"embed"``
(d_model; the FSDP axis), ``"heads"``, ``"kv_heads"``, ``"mlp"``,
``"vocab"`` (tensor-parallel), ``"experts"`` (expert-parallel),
``"head_dim"``, ``"state"``, ``"latent"`` (unsharded) and ``None``.

A step on a mesh installs its 'model' group
(:class:`~repro_torch.parallel.sharding.model_parallel`) and hands the
layers this rank's 'model' blocks of those leaves. Given the global width
of the dim that 'model' splits (``d_ff``, ``vocab_size``, ``width``), each
layer finds from its leaf whether it holds a block
(:func:`~repro_torch.parallel.sharding.layer_group`): the MLPs then run
column- then row-parallel, :func:`embed_lookup` and
:func:`lm_head_logits` / :func:`cross_entropy_loss` vocab-parallel, each
computing this rank's share and combining the shares over the group.
Given whole leaves, or with no group installed, each is the meshless
function. Under FSDP the step's parameters are also this rank's blocks over
the DP axes: :func:`layer` (a stacked leaf's block) and the models' reads
of their unstacked leaves gather them over those axes at their use
(:class:`~repro_torch.parallel.sharding.DPGather`).

Where the reference's ``einsum`` mixes dtypes, JAX promotes; ``torch``
refuses, so :func:`einsum` promotes first.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel import sharding as Sh

Params = Dict[str, object]
Axes = Dict[str, object]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands after JAX's dtype promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


class Builder:
    """Collects parameters, drawn from ``gen`` on ``device``, and their
    logical axes into two dicts of one structure.

    ``dense`` draws ``normal * scale`` in f32 (``scale`` defaults to
    ``1/sqrt(fan_in)``, ``fan_in = shape[0]``) and casts to
    ``param_dtype``, so two builds from one seed in two dtypes hold the
    same draws, rounded differently. ``by_slice=True`` draws the leaf one
    ``shape[0]`` slice at a time into its ``param_dtype`` tensor, so the
    f32 temporary is one slice (an expert's matrix) and not the leaf."""

    def __init__(self, gen: torch.Generator, param_dtype=torch.float32,
                 device=None):
        self.gen = gen
        self.device = torch.device(device or gen.device)
        self.param_dtype = param_dtype
        self.params: Params = {}
        self.axes: Axes = {}

    def dense(self, name: str, shape: Tuple[int, ...],
              axes: Tuple[Optional[str], ...], scale: Optional[float] = None,
              zero: bool = False, by_slice: bool = False) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        self.axes[name] = tuple(axes)
        if zero:
            self.params[name] = torch.zeros(shape, dtype=self.param_dtype,
                                            device=self.device)
            return
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

        def draw(sh):
            return (torch.randn(sh, generator=self.gen, dtype=torch.float32,
                                device=self.device) * s).to(self.param_dtype)

        if not by_slice or self.device.type == "meta":
            self.params[name] = draw(shape)
            return
        arr = torch.empty(shape, dtype=self.param_dtype, device=self.device)
        for i in range(shape[0]):
            arr[i] = draw(shape[1:])
        self.params[name] = arr

    def ones(self, name: str, shape: Tuple[int, ...],
             axes: Tuple[Optional[str], ...]) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        self.axes[name] = tuple(axes)
        self.params[name] = torch.ones(shape, dtype=self.param_dtype,
                                       device=self.device)

    def sub(self, name: str, params: Params, axes: Axes) -> None:
        self.params[name] = params
        self.axes[name] = axes

    def done(self) -> Tuple[Params, Axes]:
        return self.params, self.axes


def stack_layers(gen: torch.Generator, n: int,
                 init_one: Callable[[torch.Generator], Tuple[Params, Axes]]
                 ) -> Tuple[Params, Axes]:
    """``n`` blocks from ``init_one(gen) -> (params, axes)``, each leaf
    stacked along a new leading layer axis, whose logical name
    ``"layers"`` is prepended to every axes leaf. Each block is drawn into
    its slot of the stacked leaves and freed, so the build holds one block
    beyond the stack (a list of blocks and their stack would need twice
    the model). A stack of one block is that block's leaves viewed with
    the new axis: no copy (a stage of one MoE block may be half the
    card)."""
    first, ax = init_one(gen)
    axes = tree_map(lambda a: ("layers",) + a, ax)
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first), axes
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(i, block):
        tree_map(lambda dst, src: dst[i].copy_(src), out, block)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_one(gen)[0])
    return out, axes


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: Tuple = ()):
    """``(path, leaf)`` pairs of a nested-dict tree, keys sorted at each
    level: the order in which the reference's JAX tree functions see a
    dict's leaves. ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves of a nested-dict tree in :func:`tree_items`' order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, taken in
    :func:`tree_leaves`' order."""
    return _build(tree, iter(leaves))


def _build(t, it):
    """:func:`tree_unflatten`'s walk: a module function, not a closure that
    calls itself, which would hold ``leaves`` in a reference cycle (a whole
    gradient left alive until the cyclic collector runs)."""
    if isinstance(t, dict):
        out = dict.fromkeys(t)      # the keys in ``tree``'s order
        for k in sorted(t):
            out[k] = _build(t[k], it)
        return out
    return next(it)


def unstack(params: Params, n: int) -> list:
    """The ``n`` blocks of a stacked parameter tree, as views from one
    ``unbind`` per leaf. Under an installed
    :class:`~repro_torch.parallel.sharding.DPGather` each view is
    registered as split where its stacked leaf is: read a block through
    :func:`~repro_torch.parallel.sharding.dp_tree`."""
    parts = tree_map(lambda t: t.unbind(0), params)
    g = Sh.current_dp_gather()
    if g is not None:
        tree_map(lambda t, u: [g.alias(v, t) for v in u], params, parts)
    return [tree_map(lambda u, i=i: u[i], parts) for i in range(n)]


def layer(params: Params, i: int) -> Params:
    """Block ``i`` of a stacked parameter tree, as views; under an
    installed :class:`~repro_torch.parallel.sharding.DPGather` each leaf
    that the DP axes split is indexed, then gathered (one block at a
    time)."""
    g = Sh.current_dp_gather()
    if g is None:
        return _index(params, i)
    return tree_map(lambda t: g.take(t, i), params)


def _index(params, i):
    if isinstance(params, dict):
        return {k: _index(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6, *,
             mg: Optional["Sh.ModelGroup"] = None,
             width: Optional[int] = None) -> torch.Tensor:
    """Normalised in f32 and cast back to x's dtype before the gamma
    multiply, as the reference does. With a 'model' group ``mg``, ``x`` is
    this rank's block of a last dim of ``width`` (a head-split layer's
    output) and ``gamma`` that block's: the sum of squares is summed over
    the group, forward and backward (each rank's block depends on every
    rank's)."""
    x32 = x.float()
    if mg is None:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    else:
        ss = (x32 * x32).sum(dim=-1, keepdim=True)
        var = Sh.to_model(Sh.from_model(ss, mg), mg) / width
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and (population) variance in f32, normalised, cast back to x's
    dtype, then ``* gamma + beta``, as the reference does."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int. Half-split rotation (not
    interleaved), in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # [D/2]
    ang = positions[..., None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, *, d_ff: Optional[int] = None
           ) -> torch.Tensor:
    """``d_ff``: the global mlp width (default: the weights'). Where the
    weights hold this rank's 'model' block of it (gate and up
    column-parallel, down row-parallel), the output is this rank's share,
    summed over the installed 'model' group
    (:func:`~repro_torch.parallel.sharding.from_model`)."""
    mg = Sh.layer_group(w_up.shape[-1], d_ff or w_up.shape[-1])
    x = Sh.to_model(x, mg)
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    y = einsum("...f,fd->...d", F.silu(g) * u, w_down)
    return Sh.from_model(y, mg)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor, *,
             d_ff: Optional[int] = None) -> torch.Tensor:
    """The two-matrix MLP with biases (gpt_bigcode). ``jax.nn.gelu``, the
    reference's, is the tanh approximation by default; torch's default is
    the exact erf, hence ``approximate="tanh"``. ``d_ff``: as
    :func:`swiglu`'s (a block's ``b_up`` is the block of the mlp dim;
    ``b_down`` is added once, after the sum)."""
    mg = Sh.layer_group(w_up.shape[-1], d_ff or w_up.shape[-1])
    x = Sh.to_model(x, mg)
    h = F.gelu(einsum("...d,df->...f", x, w_up) + b_up, approximate="tanh")
    y = einsum("...f,fd->...d", h, w_down)
    return Sh.from_model(y, mg) + b_down


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device=None) -> Tuple[Params, Axes]:
    b = Builder(gen, dtype, device)
    b.dense("w_gate", (d_model, d_ff), ("embed", "mlp"))
    b.dense("w_up", (d_model, d_ff), ("embed", "mlp"))
    b.dense("w_down", (d_ff, d_model), ("mlp", "embed"))
    return b.done()


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device=None) -> Tuple[Params, Axes]:
    """``w_up``, ``w_down`` drawn as the other matrices, the biases
    ``b_up [d_ff]`` and ``b_down [d_model]`` zero, in the reference's key
    order."""
    b = Builder(gen, dtype, device)
    b.dense("w_up", (d_model, d_ff), ("embed", "mlp"))
    b.dense("b_up", (d_ff,), ("mlp",), zero=True)
    b.dense("w_down", (d_ff, d_model), ("mlp", "embed"))
    b.dense("b_down", (d_model,), ("embed",), zero=True)
    return b.done()


def padded_vocab(v: int, tp: int = 16, align: int = 256) -> int:
    """The reference's LM-head width: ``v`` rounded up to ``align`` unless
    it already divides by ``tp``."""
    return v if v % tp == 0 else -(-v // align) * align


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """``embed[tokens]``. Where ``embed`` is this rank's 'model' block of
    the ``vocab_size`` rows, the ids outside it give zero rows, and the
    rows are summed over the installed group (vocab-parallel)."""
    mg = Sh.layer_group(embed.shape[0], vocab_size)
    if mg is None:
        return embed[tokens]
    blk = mg.block(vocab_size)
    local = tokens.long() - blk.start
    ok = (local >= 0) & (local < blk.stop - blk.start)
    rows = embed[local.clamp(0, blk.stop - blk.start - 1)]
    return Sh.from_model(rows.masked_fill(~ok[..., None], 0), mg)


def lm_head_logits(x: torch.Tensor, head: torch.Tensor, vocab_size: int, *,
                   width: Optional[int] = None) -> torch.Tensor:
    """x: [B, S, D] @ head [D, V_pad], padded columns set to -1e30 (so
    softmax and argmax over the padded width are exact). ``width``: the
    head's global width (default: ``head``'s). Where ``head`` is this
    rank's 'model' block of columns (column-parallel), the logits are that
    block's; the padded columns are found by their global index, so
    ``padded_vocab`` keeps its meaning."""
    mg = Sh.layer_group(head.shape[-1], width or head.shape[-1])
    x = Sh.to_model(x, mg)
    logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    if mg is not None:
        w = head.shape[-1]
        col = mg.index * w + torch.arange(w, device=x.device)
        return logits.masked_fill(col >= vocab_size, -1e30)
    if head.shape[-1] != vocab_size:
        logits[..., vocab_size:] = -1e30
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, *,
                       width: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross entropy (:func:`repro.models.common.
    cross_entropy_loss`): logits ``[B, S, V]`` cast to f32, labels
    ``[B, S]``; with ``mask [B, S]`` the masked mean
    ``sum(nll * mask) / max(sum(mask), 1)``. The gold logit is gathered (the
    reference sums an iota-compare mask, which gives the same value, to
    keep a vocab-sharded tensor sharded).

    ``width``: the logits' global width (default: theirs). Where
    ``logits`` are this rank's 'model' block of it (:func:`lm_head_logits`'),
    the row max is all-reduced (``MAX``), then the sum of exponentials and
    the gold logit (``SUM``) over the installed group, so no rank forms
    ``[B, S, V]`` and the gradient is exact."""
    logits = logits.float()
    w = logits.shape[-1]
    mg = Sh.layer_group(w, width or w)
    if mg is not None:
        m = mg.all_reduce(logits.detach().amax(-1), dist.ReduceOp.MAX)
        logz = torch.log(Sh.from_model(
            torch.exp(logits - m[..., None]).sum(-1), mg)) + m
        local = labels.long() - mg.index * w
        ok = (local >= 0) & (local < w)
        gold = logits.gather(-1, local.clamp(0, w - 1)[..., None])[..., 0]
        gold = Sh.from_model(gold.masked_fill(~ok, 0.0), mg)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
