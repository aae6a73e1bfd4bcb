"""Mixture-of-Experts layer (mirrors :mod:`repro.models.moe`): top-k
routing, capacity-bounded sort-based dispatch, shared experts (DeepSeek-V3 /
Llama-4 style).

Dispatch is the reference's sort formulation: each token is replicated k
times, the copies are sorted by expert id, ranked within their expert by a
cumulative-max segment trick, and scattered into an ``[E, C, D]`` buffer
(copies ranked at or beyond the capacity C drop). The expert FFNs are
batched ``[E, C, D] x [E, D, F]`` products.

Where the two frameworks differ, the port keeps the reference's meaning:

- top-k puts the lower expert first on tied scores, as ``jax.lax.top_k``
  does (``torch.topk`` promises no order): the k come from a stable
  descending sort;
- the capacity is Python's ``round`` (half to even) of the reference's
  float expression;
- the reference's scatter drops the copies whose index is out of range
  (``mode="drop"``) where torch would raise: they are written to a spare
  row ``C`` of the buffer, which is then cut;
- the reference's gather clamps an out-of-range index, then multiplies by
  ``keep``: the index is clamped here too.

On a mesh the serving engine and the sharded train steps run each DP rank
on its own rows and install a :class:`~repro_torch.parallel.sharding.
TokenGroup`: the routing then stays the reference's over the group's
batch (the global batch; a pod's under the compressed step). Each copy
ranks after the copies of the same expert on the group's ranks before it
(an all-gather of the per-expert counts), the capacity and the chunking
are the group's batch's, and the rank's buffer holds ``min(capacity,
local tokens)`` rows per expert, enough for every copy the routing keeps.
In a train step the load-balance loss takes the group's first-choice
shares (one more all-gather), so the ranks' mean loss and gradient are
the batch's.

Expert parallelism: where the experts' matrices hold this rank's 'model'
block of the ``n_experts`` experts
(:func:`~repro_torch.parallel.sharding.layer_group`), the router stays
whole: every rank computes the same routing (the rows are the same on
every 'model' rank), fills the buffers of its own experts only and
scatters their weighted outputs; one all-reduce over 'model' sums the
ranks' shares, with no all-to-all. Where 'model' does not divide the
experts but divides their width (``expert_width``, the reference's rules
then split each expert's mlp dim), every rank holds every expert's block
of the width and each expert runs column- then row-parallel on it
(:func:`~repro_torch.parallel.sharding.to_model` before the up and gate
products, the ranks' shares summed after the down product). Where the
shared experts' matrices hold a block of their mlp width
(``shared_width``), they run column- then row-parallel. The aux values
stay the whole layer's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Builder, einsum
from repro_torch.parallel.sharding import (current_token_group, from_model,
                                           layer_group, to_model)


def init_moe(gen: torch.Generator, d_model: int, d_ff_expert: int,
             n_experts: int, n_shared: int, d_ff_shared: int, dtype,
             device=None) -> Tuple[dict, dict]:
    """The router ``[D, E]``, the experts' ``[E, D, F]`` / ``[E, F, D]``
    SwiGLU matrices (drawn expert by expert: no whole-leaf f32 temporary)
    and, with ``n_shared``, the shared experts' SwiGLU of width
    ``n_shared * d_ff_shared``."""
    b = Builder(gen, dtype, device)
    b.dense("router", (d_model, n_experts), ("embed", None))
    b.dense("w_gate", (n_experts, d_model, d_ff_expert),
            ("experts", "embed", "mlp"), by_slice=True)
    b.dense("w_up", (n_experts, d_model, d_ff_expert),
            ("experts", "embed", "mlp"), by_slice=True)
    b.dense("w_down", (n_experts, d_ff_expert, d_model),
            ("experts", "mlp", "embed"), by_slice=True)
    if n_shared > 0:
        b.dense("ws_gate", (d_model, n_shared * d_ff_shared), ("embed", "mlp"))
        b.dense("ws_up", (d_model, n_shared * d_ff_shared), ("embed", "mlp"))
        b.dense("ws_down", (n_shared * d_ff_shared, d_model), ("mlp", "embed"))
    return b.done()


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25,
              router_bias: Optional[torch.Tensor] = None,
              token_chunks: int = 1, shared_width: Optional[int] = None,
              expert_width: Optional[int] = None):
    """x: [B, S, D] -> ([B, S, D], aux dict of ``load_balance_loss`` and
    ``dropped_fraction``, 0-d f32).

    ``router_bias`` is DeepSeek-V3's aux-loss-free balancing bias, added to
    the scores for selection only. ``token_chunks`` > 1 dispatches the
    tokens in that many interleaved chunks (chunk i holds tokens i, i + c,
    i + 2c, ...), when ``T % c == 0`` and each chunk holds at least
    ``n_experts`` tokens; each chunk's capacity comes from its own token
    count, and the aux values are the chunks' means. ``shared_width``,
    ``expert_width``: the shared experts' and each routed expert's global
    mlp width (default: their matrices')."""
    B, S, D = x.shape
    T = B * S
    kw = dict(top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, router_bias=router_bias,
              shared_width=shared_width, expert_width=expert_width)
    grp = current_token_group()
    Tg = T * (grp.count if grp is not None else 1)     # the global batch's
    if token_chunks > 1 and Tg % token_chunks == 0 \
            and (Tg // token_chunks) >= n_experts:
        if T % token_chunks:
            raise ValueError(f"{T} tokens on this rank do not split into "
                             f"{token_chunks} routing chunks")
        xf = x.reshape(T // token_chunks, token_chunks, D).transpose(0, 1)
        ys, auxs = zip(*(_moe_tokens(p, xc, **kw) for xc in xf))
        y = torch.stack(ys).transpose(0, 1).reshape(B, S, D)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return y, aux
    y, aux = _moe_tokens(p, x.reshape(T, D), **kw)
    return y.reshape(B, S, D), aux


def route(p: dict, xf: torch.Tensor, *, top_k: int, n_experts: int,
          capacity_factor: float,
          router_bias: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """The routing of tokens ``xf [T, D]``: ``probs [T, E]`` (f32),
    ``idx [T, k]`` and the renormalised weights ``w [T, k]``; the sorted
    dispatch ``order``, ``se`` (expert) and ``stok`` (token) of the T k
    copies; each copy's ``rank`` within its expert, ``keep = rank < cap``
    and the capacity ``cap``."""
    T = xf.shape[0]
    dev = xf.device
    logits = einsum("td,de->te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    sel = probs if router_bias is None else probs + router_bias[None, :]
    idx = torch.sort(sel, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]           # [T, k]
    w = probs.gather(-1, idx)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)             # renormalise

    e_flat = idx.reshape(T * top_k)
    tok_of = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    pos = torch.arange(T * top_k, device=dev)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[1:] = se[1:] != se[:-1]
    seg_start = _cummax(torch.where(is_start, pos, -1))
    rank = pos - seg_start
    slot, grp = rank, current_token_group()
    if grp is None:
        cap = int(max(4, round(T * top_k / n_experts * capacity_factor)))
        rows = cap
    else:
        # rank after the earlier DP ranks' copies of the same expert, up to
        # the global batch's capacity; the slot is the local rank
        count = torch.zeros(n_experts, dtype=rank.dtype, device=dev)
        count.scatter_add_(0, e_flat, torch.ones_like(count)[e_flat])
        rank = rank + grp.before(count)[se]
        cap = int(max(4, round(T * grp.count * top_k / n_experts
                               * capacity_factor)))
        rows = min(cap, T)
    return dict(probs=probs, idx=idx, w=w, order=order, se=se,
                stok=tok_of[order], rank=rank, keep=rank < cap, cap=cap,
                slot=slot, rows=rows)


def _moe_tokens(p: dict, xf: torch.Tensor, *, top_k: int, n_experts: int,
                capacity_factor: float, router_bias,
                shared_width: Optional[int] = None,
                expert_width: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
    T, D = xf.shape
    r = route(p, xf, top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, router_bias=router_bias)
    se, keep, rows = r["se"], r["keep"], r["rows"]
    n_loc, f_loc = p["w_gate"].shape[0], p["w_gate"].shape[-1]
    ep = layer_group(n_loc, n_experts)
    # each expert on this rank's block of its width (column- then
    # row-parallel) where the experts are whole but their width is split
    wp = layer_group(f_loc, expert_width or f_loc)
    share = ep or wp        # the routed output is this rank's share
    xe, w = to_model(xf, share), to_model(r["w"], share)
    if ep is not None:
        # this rank's experts only: the other copies go to the spare row
        # (the routing, computed whole on every rank, is the same on all)
        e0 = ep.index * n_loc
        keep = keep & (se >= e0) & (se < e0 + n_loc)
        se = (se - e0).clamp(0, n_loc - 1)

    # ---- sort-based dispatch: the dropped copies land in the spare row
    rank_c = torch.where(keep, r["slot"], rows)
    buf = xf.new_zeros((n_loc, rows + 1, D)).index_put(
        (se, rank_c), xe[r["stok"]])[:, :rows]

    # ---- batched expert SwiGLU
    g = einsum("ecd,edf->ecf", buf, p["w_gate"])
    u = einsum("ecd,edf->ecf", buf, p["w_up"])
    out_e = einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"])

    # ---- gather back (out-of-range ranks clamped, then zeroed by keep)
    got = out_e[se, rank_c.clamp(max=rows - 1)] * keep[:, None].to(xf.dtype)
    back = xf.new_zeros((T * top_k, D)).index_put((r["order"],),
                                                  got.to(xf.dtype))
    back = back.reshape(T, top_k, D)
    y = einsum("tkd,tk->td", back, w.to(xf.dtype))

    # ---- shared experts (always on)
    if "ws_gate" in p:
        f_loc = p["ws_gate"].shape[-1]
        tp = layer_group(f_loc, shared_width or f_loc)
        xs = to_model(xf, tp)
        gs = einsum("td,df->tf", xs, p["ws_gate"])
        us = einsum("td,df->tf", xs, p["ws_up"])
        ys = einsum("tf,fd->td", F.silu(gs) * us, p["ws_down"])
        # the routed and shared outputs: this rank's shares are summed
        # over 'model' (once, where both are shares)
        if (tp is None) == (share is None):
            y = y + ys
        elif share is not None:
            y, share = from_model(y, share) + ys, None
        else:
            y = y + from_model(ys, tp)
    y = from_model(y, share)

    # ---- aux: Switch-style load-balance loss, and the dropped share
    me = r["probs"].mean(dim=0)                                  # [E]
    ce = F.one_hot(r["idx"][:, 0], n_experts).float().mean(dim=0)
    grp = current_token_group()
    if grp is not None and grp.aux:
        # the global batch's first-choice shares (no gradient): the ranks'
        # mean loss is then the global batch's, and so is its gradient
        ce = grp.mean(ce)
    aux = {"load_balance_loss": n_experts * (me * ce).sum(),
           "dropped_fraction": 1.0 - r["keep"].float().mean()}
    return y, aux
