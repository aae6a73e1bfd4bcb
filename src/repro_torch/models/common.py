"""Shared model components (mirrors :mod:`repro.models.common`): the
parameter builder, RMS norm, RoPE, the SwiGLU and gelu MLPs and the LM
head.

Parameters are nested dicts of tensors with the reference's layouts
(stacked ``[L, ...]`` leaves for repeated blocks, ``wq [D, H, Dh]``, ...),
so a reference parameter tree converts by copying
(:mod:`repro_torch.models.weights`). The reference's logical sharding axes
have no counterpart: the port runs on one card.

Where the reference's ``einsum`` mixes dtypes, JAX promotes; ``torch``
refuses, so :func:`einsum` promotes first.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, object]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands after JAX's dtype promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


class Builder:
    """Collects parameters, drawn from ``gen`` on ``device``, into a dict.

    ``dense`` draws ``normal * scale`` in f32 (``scale`` defaults to
    ``1/sqrt(fan_in)``, ``fan_in = shape[0]``) and casts to
    ``param_dtype``, so two builds from one seed in two dtypes hold the
    same draws, rounded differently."""

    def __init__(self, gen: torch.Generator, param_dtype=torch.float32,
                 device=None):
        self.gen = gen
        self.device = torch.device(device or gen.device)
        self.param_dtype = param_dtype
        self.params: Params = {}

    def dense(self, name: str, shape: Tuple[int, ...],
              scale: Optional[float] = None, zero: bool = False) -> None:
        if zero:
            arr = torch.zeros(shape, dtype=self.param_dtype,
                              device=self.device)
        else:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            arr = (torch.randn(shape, generator=self.gen, dtype=torch.float32,
                               device=self.device) * s).to(self.param_dtype)
        self.params[name] = arr

    def ones(self, name: str, shape: Tuple[int, ...]) -> None:
        self.params[name] = torch.ones(shape, dtype=self.param_dtype,
                                       device=self.device)

    def sub(self, name: str, params: Params) -> None:
        self.params[name] = params

    def done(self) -> Params:
        return self.params


def stack_layers(gen: torch.Generator, n: int,
                 init_one: Callable[[torch.Generator], Params]) -> Params:
    """``n`` blocks from ``init_one(gen)``, each leaf stacked along a new
    leading layer axis. Each block is drawn into its slot of the stacked
    leaves and freed, so the build holds one block beyond the stack (a
    list of blocks and their stack would need twice the model)."""
    first = init_one(gen)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(i, block):
        tree_map(lambda dst, src: dst[i].copy_(src), out, block)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_one(gen))
    return out


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
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)      # the keys in ``tree``'s order
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        return next(it)

    return build(tree)


def layer(params: Params, i: int) -> Params:
    """Block ``i`` of a stacked parameter tree, as views."""
    if isinstance(params, dict):
        return {k: layer(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalised in f32 and cast back to x's dtype before the gamma
    multiply, as the reference does."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


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
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    return einsum("...f,fd->...d", F.silu(g) * u, w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The two-matrix MLP with biases (gpt_bigcode). ``jax.nn.gelu``, the
    reference's, is the tanh approximation by default; torch's default is
    the exact erf, hence ``approximate="tanh"``."""
    h = F.gelu(einsum("...d,df->...f", x, w_up) + b_up, approximate="tanh")
    return einsum("...f,fd->...d", h, w_down) + b_down


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device=None) -> Params:
    b = Builder(gen, dtype, device)
    b.dense("w_gate", (d_model, d_ff))
    b.dense("w_up", (d_model, d_ff))
    b.dense("w_down", (d_ff, d_model))
    return b.done()


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device=None) -> Params:
    """``w_up``, ``w_down`` drawn as the other matrices, the biases
    ``b_up [d_ff]`` and ``b_down [d_model]`` zero, in the reference's key
    order."""
    b = Builder(gen, dtype, device)
    b.dense("w_up", (d_model, d_ff))
    b.dense("b_up", (d_ff,), zero=True)
    b.dense("w_down", (d_ff, d_model))
    b.dense("b_down", (d_model,), zero=True)
    return b.done()


def padded_vocab(v: int, tp: int = 16, align: int = 256) -> int:
    """The reference's LM-head width: ``v`` rounded up to ``align`` unless
    it already divides by ``tp``."""
    return v if v % tp == 0 else -(-v // align) * align


def lm_head_logits(x: torch.Tensor, head: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """x: [B, S, D] @ head [D, V_pad], padded columns set to -1e30 (so
    softmax and argmax over the padded width are exact)."""
    logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    if head.shape[-1] != vocab_size:
        logits[..., vocab_size:] = -1e30
    return logits


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (:func:`repro.models.common.
    cross_entropy_loss` without a mask): logits ``[B, S, V]`` cast to f32,
    labels ``[B, S]``. The gold logit is gathered (the reference sums an
    iota-compare mask, which gives the same value, to keep a vocab-sharded
    tensor sharded)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
