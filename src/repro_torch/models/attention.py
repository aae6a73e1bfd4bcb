"""Grouped-query self-attention, MLA and cross-attention (mirrors
:mod:`repro.models.attention`).

Two modes share one softmax core:
  prefill  full sequence, causal (with or without a KV cache)
  decode   one query token against a cached KV prefix

``impl="flash"`` routes the full-sequence causal path through the
hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`); ``"xla"`` is
the plain PyTorch path, named as in the reference. The kernel takes one
head dim for q, k and v, so MLA (q and k of ``d_nope + d_rope``, v of
``d_v``) is refused under ``"flash"``, as the reference's kernel refuses
it. Cross-attention (``causal=False``) and the encoder's non-causal
self-attention take the plain path under either ``impl``, as in the
reference, whose ``sdpa`` sends only causal ``Sq == Skv`` attention to its
kernel.

The reference's sharding constraints are called at the reference's points
(:mod:`repro_torch.parallel.sharding`: ``constrain_decode_q``,
``maybe_seq_shard_q``, ``constrain_kv_cache``); they redistribute a DTensor
under an installed mesh and leave a plain tensor as it is. On the
tensor-parallel path the query's sequence split is explicit: under an
installed 'model' group that does not divide the heads (so the layer runs
whole) but divides the query length, the plain path attends each rank's
block of query positions and all-gathers the blocks along the sequence
(:func:`~repro_torch.parallel.sharding.seq_split_group`). The flash route
comes first, as in the reference, so such a layer under ``impl="flash"``
runs the kernel whole. The serving
engine on a mesh runs each rank on plain tensors and installs a
:class:`~repro_torch.parallel.sharding.CacheBlock`: the cache writes then
keep only the new entries in this rank's sequence block, and decode
attends over the block and combines the blocks' partial softmaxes across
'model'. The prefill attends the fresh K/V (or latents), as in the
reference, so the flash kernel stays on its path. With no block installed
every path is the meshless one.

Tensor parallelism: where its leaves are this rank's 'model' blocks,
:func:`apply_gqa` runs its heads split over the installed 'model' group:
``wq`` column-parallel, ``wo`` row-parallel, ``wk``/``wv`` this rank's
blocks or, where the KV heads do not split, whole (the query heads attend
the KV heads they use). The prefill runs the flash kernel on the local
heads; the cache keeps every head. :func:`apply_mla` splits its heads
the same way (its latents have no head dim, so its cache is written whole
and decode combines every head over the rank's sequence block), and
:func:`apply_cross` as :func:`apply_gqa` with no mask, its cross cache
kept as this rank's KV heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (Builder, apply_rope, einsum,
                                       rms_norm)
from repro_torch.parallel import sharding as Sh
from repro_torch.parallel.sharding import NEG as _NEG
from repro_torch.parallel.sharding import (block_softmax, combine_blocks,
                                           constrain_decode_q,
                                           constrain_kv_cache,
                                           current_cache_block,
                                           maybe_seq_shard_q)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_positions: Optional[torch.Tensor] = None,
         kv_valid_len: Optional[torch.Tensor] = None, impl: str = "xla",
         q_chunk: int = -1, heads: Optional[int] = None) -> torch.Tensor:
    """Grouped scaled-dot-product attention.

    q, k: [B, Sq|Skv, H|Hkv, Dh]; v: [B, Skv, Hkv, Dv] with H % Hkv == 0;
    the output is [B, Sq, H, Dv] (MLA's Dv differs from Dh).
    ``q_positions``: absolute positions of the queries (causal masking
    when Sq != Skv, e.g. decode). ``kv_valid_len``: [B] valid cache
    entries (decode). ``heads``: the layer's global query head count
    (default: q's), which decides the query's sequence split over an
    installed 'model' group.
    """
    B, Sq, H, Dh = q.shape
    rep = H // k.shape[2]
    if impl == "flash" and Sq == k.shape[1] and causal \
            and kv_valid_len is None:
        if v.shape[-1] != Dh:
            raise ValueError(f"the flash kernel takes one head dim for q, k "
                             f"and v, got {Dh} and {v.shape[-1]}")
        # the kernel reads [B, S, H, D] in place: no copy unless a
        # projection returned a strided view
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)

    scale = float(1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32)))
    qpos = (q_positions if q_positions is not None
            else torch.arange(Sq, device=q.device))

    if Sq == 1 and kv_valid_len is not None:
        # decode against a sequence-sharded cache: each rank attends its
        # block, and the partial softmaxes are combined across 'model'
        q = constrain_decode_q(q)
        k = constrain_kv_cache(k)
        v = constrain_kv_cache(v)
        blk = current_cache_block()
        if blk is not None:
            m, l, o = decode_partial(q, k, v, blk.local_valid(kv_valid_len),
                                     scale, rep)
            return _grouped_out(blk.combine(m, l, o), q)
        return _decode_core_grouped(q, k, v, kv_valid_len, scale, rep)

    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    # q-chunking bounds the [B, H, q_chunk, Skv] score block
    if q_chunk < 0:
        q_chunk = Sq if Sq <= 2048 else max(1024, Sq // 16)
    if q_chunk == 0 or Sq % q_chunk != 0:
        q_chunk = Sq
    sq = Sh.seq_split_group(heads or H, Sq) if Sq > 1 else None
    if Sq > 1:
        q = maybe_seq_shard_q(q)
    if sq is not None:
        # the query's sequence split over 'model' (the heads do not divide
        # it): this rank attends its block of query positions against
        # every key; q, k and v are whole on every rank, so their gradients
        # (each rank's block's share) are summed over the group
        blk = sq.block(Sq)
        q, k, v = (Sh.to_model(t, sq) for t in (q, k, v))
        q, qpos = q[:, blk], qpos[blk]
        Sq = blk.stop - blk.start
        if Sq % q_chunk != 0:
            q_chunk = Sq
    outs = [_attn_core(q[:, i:i + q_chunk], k, v, qpos[i:i + q_chunk],
                       causal, kv_valid_len, scale)
            for i in range(0, Sq, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    # the blocks joined along the sequence (this rank's block of the
    # gradient flows back)
    return Sh.gather_model(out, sq, 1)


def _decode_core_grouped(q, k, v, kv_valid_len, scale, rep):
    """Single-token decode, grouped GQA: q [B,1,H,D], k/v [B,S,Hkv,D]."""
    B, _, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, rep, Dh)
    scores = einsum("bgrd,bkgd->bgrk", qg, k).float() * scale
    kv_idx = torch.arange(Skv, device=q.device)
    ok = kv_idx[None, :] < kv_valid_len[:, None]             # [B, Skv]
    scores = scores.masked_fill(~ok[:, None, None], _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bgrk,bkgd->bgrd", probs, v)
    return out.reshape(B, 1, H, v.shape[-1])


def decode_partial(q, k, v, valid, scale, rep):
    """One block's partial of the grouped decode: ``(m, l, o)`` of
    :func:`~repro_torch.parallel.sharding.block_softmax` over the block's
    first ``valid [B]`` entries, ``o = p @ v`` in f32 ([B, Hkv, rep] and
    [B, Hkv, rep, Dv]); q [B,1,H,D], k/v [B,S_block,Hkv,D]."""
    B, _, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, rep, Dh)
    scores = einsum("bgrd,bkgd->bgrk", qg, k).float() * scale
    ok = torch.arange(Skv, device=q.device)[None, :] < valid[:, None]
    m, l, p = block_softmax(scores, ok[:, None, None])
    o = einsum("bgrk,bkgd->bgrd", p.to(q.dtype), v).float()
    return m, l, o


def _grouped_out(o, q):
    """A combined grouped decode ``[B, Hkv, rep, Dv]`` as ``[B, 1, H, Dv]``
    in q's dtype."""
    B, _, H, _ = q.shape
    return o.to(q.dtype).reshape(B, 1, H, o.shape[-1])


def split_decode(q, k, v, kv_valid_len, n_blocks: int) -> torch.Tensor:
    """The grouped decode of q [B,1,H,D] over k/v [B,S,Hkv,D] computed as
    ``n_blocks`` equal sequence blocks (:func:`decode_partial` with each
    block's ``clamp(valid - start, 0, S / n_blocks)``) joined by
    :func:`~repro_torch.parallel.sharding.combine_blocks`, on one device:
    what the ranks of a 'model' axis of ``n_blocks`` compute together."""
    Dh, rep = q.shape[-1], q.shape[2] // k.shape[2]
    scale = float(1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32)))
    n = k.shape[1] // n_blocks
    if n * n_blocks != k.shape[1]:
        raise ValueError(f"{k.shape[1]} entries do not split into "
                         f"{n_blocks} blocks")
    parts = [decode_partial(q, k[:, i * n:(i + 1) * n],
                            v[:, i * n:(i + 1) * n],
                            (kv_valid_len - i * n).clamp(0, n), scale, rep)
             for i in range(n_blocks)]
    return _grouped_out(combine_blocks(parts), q)


def _attn_core(q, k, v, qpos, causal, kv_valid_len, scale):
    scores = einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kv_idx = torch.arange(k.shape[1], device=q.device)
    if causal:
        mask = qpos[:, None] >= kv_idx[None, :]              # [Sq, Skv]
        scores = scores.masked_fill(~mask[None, None], _NEG)
    if kv_valid_len is not None:
        ok = kv_idx[None, :] < kv_valid_len[:, None]         # [B, Skv]
        scores = scores.masked_fill(~ok[:, None, None], _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bhqk,bkhd->bqhd", probs, v)


def _write(dst, src, pos: int) -> None:
    """``src [B, S, ...]`` into the cache ``dst`` at position ``pos``, in
    place; under a cache block only the entries in this rank's block."""
    blk = current_cache_block()
    if blk is None:
        dst[:, pos:pos + src.shape[1]] = src.to(dst.dtype)
    else:
        blk.write(dst, src, pos)


# ---------------------------------------------------------------------------
# GQA self-attention block piece
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, dtype, device=None) -> Tuple[dict, dict]:
    b = Builder(gen, dtype, device)
    b.dense("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"))
    b.dense("wk", (d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim"))
    b.dense("wv", (d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim"))
    b.dense("wo", (n_heads, head_dim, d_model), ("heads", "head_dim", "embed"))
    return b.done()


def local_kv_heads(index: int, h_local: int, rep: int):
    """The KV heads that query heads ``[index * h_local, (index + 1) *
    h_local)`` use (query head ``h`` uses KV head ``h // rep``): a slice
    and the local GQA ratio when each of them serves the same number of
    consecutive local query heads, else a list of one KV head per query
    head (ratio 1)."""
    a = index * h_local
    kv = [h // rep for h in range(a, a + h_local)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    r = h_local // n
    if r * n == h_local and all(kv[j] == lo + j // r for j in range(h_local)):
        return slice(lo, lo + n), r
    return kv, 1


def apply_gqa(p: dict, x: torch.Tensor, *, positions: torch.Tensor,
              rope_theta: float = 10000.0, causal: bool = True,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: int = 0, impl: str = "xla", q_chunk: int = -1,
              n_heads: Optional[int] = None,
              n_kv_heads: Optional[int] = None):
    """x: [B, S, D]. If ``cache`` (k, v of [B, Smax, Hkv, Dh]) is given, the
    new K/V are written into it at ``cache_pos``, in place (the reference
    returns updated copies; writing in place keeps one cache on the card),
    and decode attends the cache prefix. Returns (out, cache).

    ``n_heads``, ``n_kv_heads``: the layer's global head counts (default:
    the weights'). Where ``wq`` holds this rank's 'model' block of the
    query heads (:func:`~repro_torch.parallel.sharding.layer_group`), the
    heads run split: ``wq`` column-parallel, ``wo`` row-parallel (the
    output summed over the group). ``wk``/``wv`` are then this rank's
    blocks, which its query heads use, or, where 'model' does not split
    the KV heads, whole: the K/V are projected whole (their gradient
    summed over the group) and the query heads attend the KV heads they
    use (:func:`local_kv_heads`). The prefill attends the local heads (the
    flash kernel on them); the cache keeps every KV head, so block K/V are
    all-gathered over the group before the cache is written. Decode
    all-gathers the new token's query heads (the reference replicates q),
    attends every head over the cache (this rank's sequence block under a
    :class:`~repro_torch.parallel.sharding.CacheBlock`, combined across
    'model') and feeds this rank's heads of the output to ``wo``. With
    whole weights the layer runs whole."""
    h_loc, kv_loc = p["wq"].shape[1], p["wk"].shape[1]
    mg = Sh.layer_group(h_loc, n_heads or h_loc)
    kv_mg = Sh.layer_group(kv_loc, n_kv_heads or kv_loc)
    xm = Sh.to_model(x, mg)
    q = apply_rope(einsum("bsd,dhk->bshk", xm, p["wq"]), positions,
                   rope_theta)
    xkv = xm if kv_mg is not None else x
    k = einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = einsum("bsd,dhk->bshk", xkv, p["wv"])
    if kv_mg is None:
        # whole K/V feeding this rank's query heads (none where the layer
        # runs whole): their gradient is summed over the group
        k, v = Sh.to_model(k, mg), Sh.to_model(v, mg)
    k = apply_rope(k, positions, rope_theta)
    k_att, v_att = k, v
    if mg is not None and kv_mg is None:
        heads, _ = local_kv_heads(mg.index, h_loc, h_loc * mg.size // kv_loc)
        k_att, v_att = k[:, :, heads], v[:, :, heads]

    S = x.shape[1]
    if cache is None or S > 1:
        # no cache, or a prefill (cache_pos == 0): attend the fresh K/V
        out = sdpa(q, k_att, v_att, causal=causal, impl=impl,
                   q_chunk=q_chunk, heads=n_heads)
    if cache is not None:
        ck, cv = cache
        if kv_mg is not None:
            k, v = kv_mg.all_gather(k, 2), kv_mg.all_gather(v, 2)
        _write(ck, k, cache_pos)
        _write(cv, v, cache_pos)
        ck, cv = constrain_kv_cache(ck), constrain_kv_cache(cv)
        if S == 1:
            valid = torch.full((x.shape[0],), cache_pos + S,
                               dtype=torch.int32, device=x.device)
            qa = q if mg is None else mg.all_gather(q, 2)
            out = sdpa(qa, ck, cv, causal=causal, q_positions=positions,
                       kv_valid_len=valid, impl=impl, q_chunk=q_chunk)
            if mg is not None:
                out = out[:, :, mg.block(h_loc * mg.size)]
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return Sh.from_model(y, mg), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3: latent-compressed KV with decoupled RoPE)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d_model: int, n_heads: int, *,
             q_rank: int = 1536, kv_rank: int = 512, d_nope: int = 128,
             d_rope: int = 64, d_v: int = 128, dtype=torch.float32,
             device=None) -> Tuple[dict, dict]:
    b = Builder(gen, dtype, device)
    b.dense("wq_a", (d_model, q_rank), ("embed", "latent"))
    b.ones("q_norm", (q_rank,), ("latent",))
    b.dense("wq_b", (q_rank, n_heads, d_nope + d_rope),
            ("latent", "heads", "head_dim"))
    b.dense("wkv_a", (d_model, kv_rank + d_rope), ("embed", "latent"))
    b.ones("kv_norm", (kv_rank,), ("latent",))
    b.dense("wkv_b", (kv_rank, n_heads, d_nope + d_v),
            ("latent", "heads", "head_dim"))
    b.dense("wo", (n_heads, d_v, d_model), ("heads", "head_dim", "embed"))
    return b.done()


def apply_mla(p: dict, x: torch.Tensor, *, positions: torch.Tensor,
              d_nope: int = 128, d_rope: int = 64, d_v: int = 128,
              kv_rank: int = 512, rope_theta: float = 10000.0,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: int = 0, absorbed: bool = False,
              impl: str = "xla", q_chunk: int = -1,
              n_heads: Optional[int] = None):
    """Multi-head Latent Attention. The cache holds ``(c_kv [B, Smax,
    kv_rank], k_rope [B, Smax, d_rope])``, written in place at
    ``cache_pos``. Returns (out, cache).

    ``absorbed=False`` expands K/V from the latent at every step (the
    paper's compute). ``absorbed=True`` folds ``wkv_b`` into the query and
    output projections, so attention runs in the latent space and never
    materialises K/V. The q and kv norms take ``rms_norm``'s default eps,
    as the reference's do.

    ``n_heads``: the global head count (default: the weights'). Where
    ``wq_b`` holds this rank's 'model' block of the heads
    (:func:`~repro_torch.parallel.sharding.layer_group`), so do ``wkv_b``
    and ``wo``, and the heads run split: ``wq_a``, ``wkv_a`` and the norms
    are whole, the latents ``q_lat``, ``c_kv`` and ``k_rope`` feed this
    rank's heads (their gradient summed over the group) and ``wo`` is
    row-parallel. The prefill attends this rank's heads (their K/V
    expanded from the latents, or ``wkv_b``'s block folded in); the latent
    cache has no head dim, so it is written whole (this rank's sequence
    block under a :class:`~repro_torch.parallel.sharding.CacheBlock`).
    Decode over a cache block, as :func:`apply_gqa`'s: the new token's
    queries of every head are all-gathered (absorbed: ``q_nope`` folded
    into the latent, with ``q_rope``; plain: ``q`` and, to expand every
    head's K/V over the block, ``wkv_b``), every head attends this rank's
    sequence block, the blocks' partial softmaxes are combined across
    'model', and this rank's heads go on to ``wo``."""
    B, S, _ = x.shape
    h_loc = p["wq_b"].shape[1]
    mg = Sh.layer_group(h_loc, n_heads or h_loc)
    q_lat = rms_norm(einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
    q = einsum("bsr,rhk->bshk", Sh.to_model(q_lat, mg), p["wq_b"])
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)

    kv_a = einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :kv_rank], p["kv_norm"])
    k_rope_new = apply_rope(kv_a[..., kv_rank:][:, :, None, :], positions,
                            rope_theta)[:, :, 0, :]

    c_all, r_all, valid = c_kv, k_rope_new, None
    if cache is not None:
        cc, cr = cache
        _write(cc, c_kv, cache_pos)
        _write(cr, k_rope_new, cache_pos)
        cc, cr = constrain_kv_cache(cc), constrain_kv_cache(cr)
        if S == 1:
            # decode: attend the cache; prefill attends the fresh latents
            c_all, r_all = cc, cr
            valid = torch.full((B,), cache_pos + S, dtype=torch.int32,
                               device=x.device)
    # the latents feed this rank's heads: their gradient summed over 'model'
    c_all, r_all = Sh.to_model(c_all, mg), Sh.to_model(r_all, mg)

    blk = current_cache_block() if valid is not None else None
    # decode over a cache block on split heads: every head attends the block
    spread = mg is not None and blk is not None
    if absorbed:
        scale = float(1.0 / torch.sqrt(torch.tensor(d_nope + d_rope,
                                                    dtype=torch.float32)))
        kv_idx = torch.arange(c_all.shape[1], device=x.device)
        wk_b = p["wkv_b"][..., :d_nope]                 # [r, H, d_nope]
        wv_b = p["wkv_b"][..., d_nope:]                 # [r, H, d_v]
        q_eff = einsum("bshk,rhk->bshr", q_nope, wk_b)
        if spread:
            # q_rope is at most q_eff's width: the round trip is exact
            qq = mg.all_gather(torch.cat([q_eff, q_rope.to(q_eff.dtype)],
                                         dim=-1), 2)
            r = q_eff.shape[-1]
            q_eff, q_rope = qq[..., :r], qq[..., r:].to(q_rope.dtype)
        s_nope = einsum("bshr,btr->bhst", q_eff, c_all)
        s_rope = einsum("bshk,btk->bhst", q_rope, r_all)
        scores = (s_nope + s_rope).float() * scale
        if blk is not None:
            # decode over this rank's block of the latents (its entries
            # sit at start + kv_idx, all at or before the query's
            # position once below the block's valid count)
            ok = kv_idx[None, :] < blk.local_valid(valid)[:, None]
            m, l, pr = block_softmax(scores, ok[:, None, None])
            ctx_part = einsum("bhst,btr->bhsr", pr.to(x.dtype), c_all)
            ctx_lat = blk.combine(m, l, ctx_part.float()).to(
                x.dtype).transpose(1, 2)
            if spread:
                ctx_lat = ctx_lat[:, :, mg.block(h_loc * mg.size)]
        else:
            mask = positions[:, None] >= kv_idx[None, :]
            scores = scores.masked_fill(~mask[None, None], _NEG)
            if valid is not None:
                ok = kv_idx[None, :] < valid[:, None]
                scores = scores.masked_fill(~ok[:, None, None], _NEG)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx_lat = einsum("bhst,btr->bshr", probs, c_all)
        out = einsum("bshr,rhv->bshv", ctx_lat, wv_b)
    else:
        wkv_b = p["wkv_b"]
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if spread:
            wkv_b = mg.all_gather(wkv_b, 1)
            q_full = mg.all_gather(q_full, 2)
        kv = einsum("btr,rhk->bthk", c_all, wkv_b)
        k_nope, v = kv[..., :d_nope], kv[..., d_nope:]
        H = kv.shape[2]
        k_full = torch.cat([k_nope, r_all[:, :, None, :].expand(
            *r_all.shape[:2], H, d_rope).to(k_nope.dtype)], dim=-1)
        out = sdpa(q_full, k_full, v, causal=True, q_positions=positions,
                   kv_valid_len=valid, impl=impl, q_chunk=q_chunk,
                   heads=n_heads)
        if spread:
            out = out[:, :, mg.block(H)]
    y = einsum("bshv,hvd->bsd", out, p["wo"])
    return Sh.from_model(y, mg), cache


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers, enc-dec decoder)
# ---------------------------------------------------------------------------

def init_cross(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
               head_dim: int, d_ctx: int, dtype,
               device=None) -> Tuple[dict, dict]:
    b = Builder(gen, dtype, device)
    b.dense("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"))
    b.dense("wk", (d_ctx, n_kv, head_dim), ("embed", "kv_heads", "head_dim"))
    b.dense("wv", (d_ctx, n_kv, head_dim), ("embed", "kv_heads", "head_dim"))
    b.dense("wo", (n_heads, head_dim, d_model), ("heads", "head_dim", "embed"))
    return b.done()


def apply_cross(p: dict, x: torch.Tensor, ctx: Optional[torch.Tensor] = None,
                *, kv_cache: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                impl: str = "xla", q_chunk: int = -1,
                n_heads: Optional[int] = None,
                n_kv_heads: Optional[int] = None):
    """Cross-attention of ``x [B, S, D]`` over ``ctx [B, T, d_ctx]``: the
    K/V ``[B, T, Hkv, Dh]`` are projected from ``ctx``, or taken from
    ``kv_cache`` when one is passed (decode). Returns ``(y, (k, v))``; the
    caller keeps ``(k, v)`` as the layer's cache. Non-causal, so the plain
    path under either ``impl``.

    ``n_heads``, ``n_kv_heads``: the global head counts (default: the
    weights'). Split as :func:`apply_gqa`, with no RoPE and no mask: where
    ``wq`` holds this rank's 'model' block of the heads, ``wq`` is
    column-parallel and ``wo`` row-parallel; ``wk``/``wv`` are this rank's
    blocks of the KV heads or, where 'model' does not split them, whole
    (the query heads attend the KV heads they use). The returned ``(k, v)``
    are then this rank's KV heads (or every one), as the cache keeps them:
    decode reads its own block and moves nothing."""
    h_loc, kv_loc = p["wq"].shape[1], p["wk"].shape[1]
    mg = Sh.layer_group(h_loc, n_heads or h_loc)
    kv_mg = Sh.layer_group(kv_loc, n_kv_heads or kv_loc)
    q = einsum("bsd,dhk->bshk", Sh.to_model(x, mg), p["wq"])
    if kv_cache is None:
        c = Sh.to_model(ctx, kv_mg)
        k = einsum("btc,chk->bthk", c, p["wk"])
        v = einsum("btc,chk->bthk", c, p["wv"])
        if kv_mg is None:
            # whole K/V feeding this rank's query heads
            k, v = Sh.to_model(k, mg), Sh.to_model(v, mg)
    else:
        k, v = kv_cache
    k_att, v_att = k, v
    if mg is not None and kv_mg is None:
        heads, _ = local_kv_heads(mg.index, h_loc, h_loc * mg.size // kv_loc)
        k_att, v_att = k[:, :, heads], v[:, :, heads]
    out = sdpa(q, k_att, v_att, causal=False, impl=impl, q_chunk=q_chunk,
               heads=n_heads)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return Sh.from_model(y, mg), (k, v)
