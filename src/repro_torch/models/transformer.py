"""Model families of the port (mirrors :mod:`repro.models.transformer`).

``DecoderLM`` runs the reference's dense, MoE and VLM layer plans: stages
of pre-norm residual blocks, each stage's parameters stacked ``[n, ...]``
under ``"stage<i>"``, as in the reference. A block is self-attention (GQA,
or MLA under ``use_mla``), or in a VLM's cross block cross-attention over
``ctx``, and an FFN: SwiGLU, under ``mlp_type="gelu"`` the two-matrix gelu
MLP with biases, or in a MoE block the routed experts of
:mod:`repro_torch.models.moe`. The plans:

  ``[("dense", L)]``                      no experts
  ``[("dense", n_dense), ("moe", n)]``    every layer after the first
                                          ``n_dense_layers`` is MoE
  ``[..., ("moe_super", n, k - 1), ...]`` ``moe_interleave = k > 1``: each
                                          super block is k - 1 dense
                                          blocks (``"dense"``, stacked
                                          ``[n, k - 1, ...]``) then one
                                          MoE block (``"moe"``)
  ``[("vlm_super", n, k - 1), ...]``      ``family="vlm"``, ``cross_every =
                                          k > 1``: each super block is k - 1
                                          self blocks (``"selfs"``, stacked
                                          ``[n, k - 1, ...]``) then one
                                          cross block (``"cross"``); a
                                          ``("dense", rem)`` stage follows
                                          when k does not divide the layers

It trains (``loss_fn``: cross entropy plus ``moe_aux_coef`` times the MoE
layers' summed load-balance loss), serves (``prefill``, ``decode_step``)
and runs a full forward (``_forward``, the logits; ``_forward_aux``, the
logits and the summed aux loss). The VLM takes its image patches as ``ctx
[B, n_ctx, d_ctx]`` (the vision frontend is a stub, as in the reference) in
the compute dtype only: another dtype raises ``TypeError``, where the
reference promotes (an f32 ``ctx`` turns a bf16 model's residual to f32,
which its layer scan then refuses). At prefill the cross blocks' K/V are
projected from ``ctx`` and written into the cache in place; decode reads
them from there.

``EncDec`` (seamless-m4t): a non-causal encoder over precomputed frame
embeddings (the audio frontend is a stub), and a decoder of self-attention,
cross-attention over the encoder's output and SwiGLU. ``prefill`` takes the
frames as ``ctx`` and raises ``ValueError`` without them.

``HybridSSM`` (zamba2): a Mamba-2 backbone with ONE shared attention block
applied after every ``attn_every`` Mamba blocks, then the trailing Mamba
blocks. It runs the full-sequence forward and loss (``loss_fn``, through
the ``mamba2_scan`` kernel under ``ssm_impl="mamba_kernel"``) and serves.
Its shared block is dense whatever ``n_experts`` says, as the reference
builds it (``moe_ffn=False``). Under ``use_mla`` the shared block is MLA:
it trains, but ``prefill`` and ``decode_step`` raise ``ValueError``, since
the reference writes MLA's latent into the GQA-shaped shared cache and
fails there.

A Python loop over the layers takes the place of the reference's
``lax.scan``; ``stream_unroll`` is kept as a field and means nothing here.
``remat="block"`` recomputes each step of a stage (a block, a MoE or VLM
super block, an encoder or decoder layer) in the backward, as the
reference's ``jax.checkpoint`` of its scan body does: :func:`_maybe_remat`
wraps it, or a HybridSSM group of Mamba
blocks and its shared attention, in ``torch.utils.checkpoint`` when
autograd records. The kernels have no backward
(``ModelConfig.attn_impl="flash"`` and ``ssm_impl="mamba_kernel"`` raise
under autograd on the card, as ``jax.grad`` through the reference's
kernels does), so training runs the plain routes, the reference's
defaults. MLA is refused under ``attn_impl="flash"`` (the kernel takes one
head dim for q, k and v; MLA's v is narrower), and so is MLA in a
``moe_super`` or VLM plan, whose cache the reference builds but cannot
index.

``XLSTM`` (xlstm-125m): ``n_layers // 2`` super blocks, each an mLSTM then
an sLSTM block (:mod:`repro_torch.models.xlstm`) with pre-norm residuals.
It has no attention and no kernel on its path: ``attn_impl`` and
``ssm_impl`` mean nothing to it. Training runs the mLSTM's chunkwise form;
the prefill passes the cache's states in, so it runs the step recurrence
over every prompt token, as the reference's does.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.mamba2_scan import kernel_takes
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.common import (Builder, cross_entropy_loss,
                                       embed_lookup, gelu_mlp, init_gelu_mlp,
                                       init_swiglu, layer, lm_head_logits,
                                       padded_vocab, rms_norm, stack_layers,
                                       swiglu, tree_items, tree_leaves,
                                       unstack)
from repro_torch.parallel import sharding as Sh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    # --- MoE
    n_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_interleave: int = 1        # every k-th layer uses MoE FFN
    n_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_token_chunks: int = 1      # stream dispatch over token chunks
    # --- MLA
    use_mla: bool = False
    q_rank: int = 1536
    kv_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    mla_absorbed: bool = False
    # --- SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4
    attn_every: int = 0            # hybrid: shared attn after every k ssm blocks
    ssd_chunk: int = 128
    # --- VLM
    cross_every: int = 0           # every k-th layer is a cross-attn layer
    n_ctx: int = 0                 # context tokens (image patches / frames)
    d_ctx: int = 0
    # --- enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    mlp_type: str = "swiglu"       # swiglu | gelu (2-matrix, gpt_bigcode)
    # --- runtime
    attn_q_chunk: int = -1         # -1 auto; 0 disable (audit mode)
    stream_unroll: bool = False    # unroll streaming scans (audit mode)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"            # none | block
    attn_impl: str = "xla"         # xla | flash
    ssm_impl: str = "xla"          # xla | mamba_kernel
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdt(self):
        return DTYPES[self.param_dtype]

    @property
    def cdt(self):
        return DTYPES[self.compute_dtype]

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS and memory estimates), from a
        shapes-only init on the meta device."""
        params = get_model(self).init(0, device="meta")
        return sum(t.numel() for t in tree_leaves(params))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: the shared and the top_k
        routed experts), by the reference's formula."""
        total = self.param_count()
        if self.n_experts == 0:
            return total
        per_expert = 3 * self.d_model * self.moe_d_ff
        n_moe_layers = max((self.n_layers - self.n_dense_layers)
                           // max(self.moe_interleave, 1), 1)
        return total - n_moe_layers * (self.n_experts
                                       - self.moe_top_k) * per_expert


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward under ``remat="block"`` while
    autograd records; ``fn`` itself otherwise. The blocks draw no random
    numbers, so no RNG state is kept for the recompute. Forward and
    recompute run in the context of the call that made the wrapper, so the
    recompute sees the same installed 'model' and token groups wherever
    autograd runs it (the card's backward runs on a thread of its own)."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return fn
    ctx = contextvars.copy_context()
    return functools.partial(checkpoint, lambda *a: ctx.run(fn, *a),
                             use_reentrant=False, preserve_rng_state=False)


def head_width(cfg: ModelConfig) -> int:
    """The LM head's global width: the vocabulary where a decoder ties the
    head to the embedding, else ``padded_vocab`` of it (the hybrid, the
    xLSTM and the encoder-decoder never tie, as in the reference)."""
    if cfg.tie_embeddings and cfg.family in _DECODER_FAMILIES:
        return cfg.vocab_size
    return padded_vocab(cfg.vocab_size)


def _embed(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype (vocab-parallel where
    ``embed`` is this rank's 'model' block; gathered over the DP axes
    that split it, :func:`~repro_torch.parallel.sharding.dp_leaf`)."""
    return embed_lookup(Sh.dp_leaf(params["embed"]), tokens,
                        cfg.vocab_size).to(cfg.cdt)


def _logits(cfg: ModelConfig, x, params) -> torch.Tensor:
    """The head's logits: ``lm_head``, or the embedding transposed where
    the tree has no ``lm_head`` (a tied decoder), each gathered over the
    DP axes that split it; this rank's block of the vocabulary where the
    head is this rank's 'model' block."""
    head = (Sh.dp_leaf(params["lm_head"]) if "lm_head" in params
            else Sh.dp_leaf(params["embed"]).T)
    return lm_head_logits(x, head, cfg.vocab_size, width=head_width(cfg))


def _final_norm(cfg: ModelConfig, x, gamma) -> torch.Tensor:
    """The final RMS norm with ``gamma`` (``ln_f``, ``ln_enc``, ``ln_dec``)
    gathered over the DP axes that split it."""
    return rms_norm(x, Sh.dp_leaf(gamma), cfg.norm_eps)


def _loss(cfg: ModelConfig, logits, labels) -> torch.Tensor:
    return cross_entropy_loss(logits, labels, width=head_width(cfg))


# ---------------------------------------------------------------------------
# the block: GQA or MLA self-attention + SwiGLU, gelu MLP or MoE
# ---------------------------------------------------------------------------

def _init_attn_block(gen, cfg: ModelConfig, device, moe_ffn: bool = False,
                     cross: bool = False) -> Tuple[dict, dict]:
    b = Builder(gen, cfg.pdt, device)
    b.ones("ln1", (cfg.d_model,), ("embed",))
    b.ones("ln2", (cfg.d_model,), ("embed",))
    if cross:
        b.sub("attn", *A.init_cross(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd,
                                    cfg.d_ctx or cfg.d_model, cfg.pdt,
                                    device))
    elif cfg.use_mla:
        b.sub("attn", *A.init_mla(gen, cfg.d_model, cfg.n_heads,
                                  q_rank=cfg.q_rank, kv_rank=cfg.kv_rank,
                                  d_nope=cfg.d_nope, d_rope=cfg.d_rope,
                                  d_v=cfg.d_v, dtype=cfg.pdt, device=device))
    else:
        b.sub("attn", *A.init_gqa(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd, cfg.pdt, device))
    if moe_ffn:
        b.sub("ffn", *MOE.init_moe(gen, cfg.d_model, cfg.moe_d_ff,
                                   cfg.n_experts, cfg.n_shared_experts,
                                   cfg.moe_d_ff, cfg.pdt, device))
    else:
        init_mlp = init_gelu_mlp if cfg.mlp_type == "gelu" else init_swiglu
        b.sub("ffn", *init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt, device))
    return b.done()


def _apply_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
               moe_ffn: bool = False):
    """``(y, aux)``: a MoE block's load-balance loss (0-d f32), else 0.0 (a
    Python float, so the dense plan adds no operation for it)."""
    if moe_ffn:
        y, aux = MOE.apply_moe(
            p, x, top_k=cfg.moe_top_k, n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor,
            token_chunks=cfg.moe_token_chunks,
            shared_width=cfg.n_shared_experts * cfg.moe_d_ff,
            expert_width=cfg.moe_d_ff)
        return y, aux["load_balance_loss"]
    if cfg.mlp_type == "gelu":
        return gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"],
                        p["b_down"], d_ff=cfg.d_ff), 0.0
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], d_ff=cfg.d_ff), 0.0


def _apply_attn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions, cache=None, cache_pos: int = 0,
                      moe_ffn: bool = False, ctx=None, cross: bool = False):
    """``(x, cache, aux)``. A cross block (``cross=True``) projects its K/V
    from ``ctx`` and, given a ``cache``, writes them into it in place (a
    prefill); with no ``ctx`` it reads them from ``cache`` (a decode)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cross:
        att, kv = A.apply_cross(p["attn"], h, ctx,
                                kv_cache=cache if ctx is None else None,
                                impl=cfg.attn_impl, q_chunk=cfg.attn_q_chunk,
                                n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads)
        if cache is not None and ctx is not None:
            for dst, src in zip(cache, kv):
                dst.copy_(src)
        new_cache = kv if cache is None else cache
    elif cfg.use_mla:
        att, new_cache = A.apply_mla(
            p["attn"], h, positions=positions, d_nope=cfg.d_nope,
            d_rope=cfg.d_rope, d_v=cfg.d_v, kv_rank=cfg.kv_rank,
            rope_theta=cfg.rope_theta, cache=cache, cache_pos=cache_pos,
            absorbed=cfg.mla_absorbed, impl=cfg.attn_impl,
            q_chunk=cfg.attn_q_chunk, n_heads=cfg.n_heads)
    else:
        att, new_cache = A.apply_gqa(
            p["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
            cache=cache, cache_pos=cache_pos, impl=cfg.attn_impl,
            q_chunk=cfg.attn_q_chunk, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    f, aux = _apply_ffn(p["ffn"], h2, cfg, moe_ffn)
    return x + f, new_cache, aux


_DECODER_FAMILIES = ("dense", "moe", "vlm")


def _check_ported(cfg: ModelConfig, family: str) -> None:
    """Refuses a config of another family than the model's (``family``:
    ``"decoder"`` for :class:`DecoderLM`, ``"hybrid"``, ``"ssm"``,
    ``"audio"``), a config without the fields
    of its family (the reference asserts ``attn_every > 0``,
    ``cross_every > 1``, ``n_enc_layers and n_dec_layers``), and the MLA
    combinations the reference cannot run."""
    if (cfg.family not in _DECODER_FAMILIES if family == "decoder"
            else cfg.family != family):
        raise ValueError(f"{cfg.name}: a {cfg.family!r} config is not a "
                         f"{family!r} model's")
    if cfg.family == "vlm" and cfg.cross_every <= 1:
        raise ValueError(f"{cfg.name}: a vlm config needs cross_every > 1 "
                         f"(k - 1 self layers per cross layer), got "
                         f"{cfg.cross_every}")
    if family == "audio":
        if cfg.n_enc_layers < 1 or cfg.n_dec_layers < 1:
            raise ValueError(f"{cfg.name}: an encoder-decoder config needs "
                             f"n_enc_layers >= 1 and n_dec_layers >= 1, got "
                             f"{cfg.n_enc_layers} and {cfg.n_dec_layers}")
        return
    if family == "hybrid" and (cfg.attn_every < 1 or cfg.ssm_state < 1):
        raise ValueError(f"{cfg.name}: a hybrid config needs attn_every "
                         f">= 1 and ssm_state >= 1, got {cfg.attn_every} "
                         f"and {cfg.ssm_state}")
    if not cfg.use_mla:
        return
    if family != "hybrid" and (cfg.family == "vlm" or (
            cfg.n_experts > 0 and cfg.moe_interleave > 1)):
        raise ValueError(
            f"{cfg.name}: MLA in a super block plan (family {cfg.family!r}, "
            f"moe_interleave={cfg.moe_interleave}) is refused: the reference "
            "builds one latent cache per stage there, which its super block "
            "cannot index")
    d_qk = cfg.d_nope + cfg.d_rope
    if cfg.attn_impl == "flash" and d_qk != cfg.d_v:
        raise ValueError(
            f"{cfg.name}: MLA under attn_impl='flash' is refused: the flash "
            f"kernel takes one head dim for q, k and v, and MLA's q and k "
            f"have d_nope + d_rope = {d_qk} where v has d_v = {cfg.d_v} (the "
            "reference's kernel fails on it too); use attn_impl='xla'")


def _with_axes(built, with_axes: bool):
    """A model's ``init`` result: ``(params, axes)`` with ``with_axes``,
    else the parameters alone (the port's one-device signature)."""
    return built if with_axes else built[0]


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    """A generator for drawing on ``dev``; on the meta device (shapes only,
    no memory) a CPU generator, which torch accepts there."""
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


def _check_ctx(cfg: ModelConfig, ctx) -> None:
    """A VLM's ``ctx`` is in the compute dtype: the reference promotes a
    wider one, which turns the residual to f32 (its layer scan then fails,
    and here the next self layers would leave flash's bf16 route)."""
    if ctx is not None and ctx.dtype != cfg.cdt:
        raise TypeError(f"{cfg.name}: ctx is {ctx.dtype}, the model computes "
                        f"in {cfg.cdt}; pass ctx in {cfg.cdt}")


def _at(cache, i):
    """Entry ``i`` of a stacked cache (a tuple of tensors, or a dict of
    them), as views; ``None`` stays ``None``."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: _at(v, i) for k, v in cache.items()}
    return tuple(t[i] for t in cache)


# ---------------------------------------------------------------------------
# DecoderLM: the dense, MoE and VLM plans
# ---------------------------------------------------------------------------

# a super block's keys: its stacked self blocks, then its last block
_SUPER_KEYS = {"moe_super": ("dense", "moe"), "vlm_super": ("selfs", "cross")}

class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg, "decoder")
        self.cfg = c = cfg
        # the plan: (kind, count, inner) stages, as the reference's
        if c.family == "vlm":
            n_super = c.n_layers // c.cross_every
            self.plan = [("vlm_super", n_super, c.cross_every - 1)]
            rem = c.n_layers - n_super * c.cross_every
            if rem:
                self.plan.append(("dense", rem, 0))
        elif c.n_experts > 0:
            self.plan = []
            if c.n_dense_layers:
                self.plan.append(("dense", c.n_dense_layers, 0))
            n_rest = c.n_layers - c.n_dense_layers
            if c.moe_interleave > 1:
                n_super = n_rest // c.moe_interleave
                self.plan.append(("moe_super", n_super, c.moe_interleave - 1))
                rem = n_rest - n_super * c.moe_interleave
                if rem:
                    self.plan.append(("dense", rem, 0))
            else:
                self.plan.append(("moe", n_rest, 0))
        else:
            self.plan = [("dense", c.n_layers, 0)]

    # ---------------- init
    def init(self, seed: int = 0, device=None, with_axes: bool = False):
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one; ``"meta"``: shapes only);
        ``with_axes``: ``(params, axes)``, the logical axes tree beside
        them, as the reference's ``init`` returns."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), ("vocab", "embed"),
                scale=0.02)
        b.ones("ln_f", (c.d_model,), ("embed",))
        if not c.tie_embeddings:
            b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)),
                    ("embed", "vocab"))
        for si, (kind, n, inner) in enumerate(self.plan):
            if kind in _SUPER_KEYS:
                selfs, last = _SUPER_KEYS[kind]

                def init_one(g, inner=inner, kind=kind, selfs=selfs,
                             last=last):
                    bb = Builder(g, c.pdt, dev)
                    bb.sub(selfs, *stack_layers(
                        g, inner, lambda gg: _init_attn_block(gg, c, dev)))
                    bb.sub(last, *_init_attn_block(
                        g, c, dev, moe_ffn=kind == "moe_super",
                        cross=kind == "vlm_super"))
                    return bb.done()
            else:
                def init_one(g, moe=kind == "moe"):
                    return _init_attn_block(g, c, dev, moe_ffn=moe)
            b.sub(f"stage{si}", *stack_layers(gen, n, init_one))
        return _with_axes(b.done(), with_axes)

    def _step(self, kind: str, inner: int, p, x, positions, cache=None,
              pos: int = 0, ctx=None):
        """One step of a stage: a block, or a super block's ``inner`` self
        blocks then its MoE or cross block (over ``ctx``); ``p`` and
        ``cache`` are the step's entries. Returns ``(x, aux)``."""
        c = self.cfg
        if kind not in _SUPER_KEYS:
            x, _, aux = _apply_attn_block(p, x, c, positions=positions,
                                          cache=cache, cache_pos=pos,
                                          moe_ffn=kind == "moe")
            return x, aux
        selfs, last = _SUPER_KEYS[kind]
        for j in range(inner):      # self blocks: their aux is 0.0
            x, _, _ = _apply_attn_block(
                layer(p[selfs], j), x, c, positions=positions,
                cache=None if cache is None else _at(cache[selfs], j),
                cache_pos=pos)
        x, _, aux = _apply_attn_block(
            p[last], x, c, positions=positions,
            cache=None if cache is None else cache[last], cache_pos=pos,
            moe_ffn=kind == "moe_super", ctx=ctx, cross=kind == "vlm_super")
        return x, aux

    # ---------------- forward (no cache)
    def _forward_aux(self, params, tokens: torch.Tensor, ctx=None):
        """Logits [B, S, V_pad] of the full sequence, and the MoE blocks'
        load-balance losses summed (0-d f32; the Python 0.0 for the dense
        and VLM plans). A VLM attends ``ctx [B, n_ctx, d_ctx]``."""
        c = self.cfg
        if c.family == "vlm":
            if ctx is None:
                raise ValueError(f"{c.name}: the vlm forward needs ctx")
            _check_ctx(c, ctx)
        x = _embed(c, params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux_total = 0.0
        for si, (kind, n, inner) in enumerate(self.plan):
            sp = params[f"stage{si}"]

            def step(xx, i, kind=kind, inner=inner, sp=sp):
                return self._step(kind, inner, layer(sp, i), xx, positions,
                                  ctx=ctx)

            step = _maybe_remat(step, c)
            for i in range(n):
                x, aux = step(x, i)
                aux_total = aux_total + aux
        x = _final_norm(c, x, params["ln_f"])
        return _logits(c, x, params), aux_total

    def _forward(self, params, tokens: torch.Tensor,
                 ctx=None) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full sequence."""
        return self._forward_aux(params, tokens, ctx)[0]

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``[B, S]``; a VLM's ``batch["ctx"]`` its
        patches) plus ``moe_aux_coef`` times the summed load-balance loss (0
        for the dense and VLM plans): ``(total, {"ce_loss", "aux_loss"})``,
        as the reference returns."""
        logits, aux = self._forward_aux(params, batch["tokens"],
                                        batch.get("ctx"))
        loss = _loss(self.cfg, logits, batch["labels"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + self.cfg.moe_aux_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int, device=None,
                   n_ctx: Optional[int] = None) -> Dict[str, Any]:
        """Zero caches per stage in the compute dtype, as the reference's:
        under MLA the latents ``(c_kv [n, B, max_len, kv_rank], k_rope [n,
        B, max_len, d_rope])``; else K/V ``[n, B, max_len, Hkv, Dh]``; for a
        MoE super block ``{"dense": (k, v) [n, inner, ...], "moe": (k, v)
        [n, ...]}``, for a VLM super block ``{"selfs": (k, v) [n, inner,
        ...], "cross": (k, v) [n, B, n_ctx, Hkv, Dh]}`` (``n_ctx``: the
        config's unless given; under an installed 'model' group that splits
        the KV heads, ``Hkv`` is this rank's share there,
        :func:`~repro_torch.parallel.sharding.local_count`)."""
        c = self.cfg
        dev = resolve_device(device)

        def mk(*lead, tail, length=max_len):
            return tuple(torch.zeros(lead + (batch_size, length) + t,
                                     dtype=c.cdt, device=dev) for t in tail)

        kv = ((c.n_kv_heads, c.hd),) * 2
        cross_kv = ((Sh.local_count(c.n_kv_heads), c.hd),) * 2
        cache: Dict[str, Any] = {}
        for si, (kind, n, inner) in enumerate(self.plan):
            if c.use_mla:
                cache[f"stage{si}"] = mk(n, tail=((c.kv_rank,), (c.d_rope,)))
            elif kind == "moe_super":
                cache[f"stage{si}"] = {"dense": mk(n, inner, tail=kv),
                                       "moe": mk(n, tail=kv)}
            elif kind == "vlm_super":
                cache[f"stage{si}"] = {
                    "selfs": mk(n, inner, tail=kv),
                    "cross": mk(n, tail=cross_kv, length=n_ctx or c.n_ctx)}
            else:
                cache[f"stage{si}"] = mk(n, tail=kv)
        return cache

    def _with_cache(self, params, tokens: torch.Tensor, cache, pos: int,
                    ctx=None):
        """Shared prefill/decode path: runs tokens (S >= 1) at cache offset
        ``pos``, writing the cache in place (a VLM's cross K/V from ``ctx``
        when it is given, at prefill). Returns the last position's logits
        [B, 1, V_pad] and the cache."""
        c = self.cfg
        x = _embed(c, params, tokens)
        positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
        for si, (kind, n, inner) in enumerate(self.plan):
            sp, sc = params[f"stage{si}"], cache[f"stage{si}"]
            for i in range(n):
                x, _ = self._step(kind, inner, layer(sp, i), x, positions,
                                  cache=_at(sc, i), pos=pos, ctx=ctx)
        x = _final_norm(c, x, params["ln_f"])
        logits = _logits(c, x[:, -1:], params)
        return logits, cache

    def prefill(self, params, tokens: torch.Tensor, max_len: int, ctx=None):
        """The prompt's last logits and the cache; a VLM's ``ctx [B, n_ctx,
        d_ctx]`` fills the cross blocks' K/V (without it they attend the
        zero cache, as the reference's do). Other plans ignore ``ctx``."""
        if self.cfg.family != "vlm":
            ctx = None
        _check_ctx(self.cfg, ctx)
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device,
                                n_ctx=None if ctx is None else ctx.shape[1])
        return self._with_cache(params, tokens, cache, 0, ctx)

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: int):
        return self._with_cache(params, tokens, cache, pos)


# ---------------------------------------------------------------------------
# HybridSSM (zamba2): Mamba2 backbone + shared attention block
# ---------------------------------------------------------------------------

class HybridSSM:
    """``n_super = n_layers // attn_every`` groups of ``attn_every`` Mamba
    blocks, each group followed by the shared attention block, then
    ``n_tail`` Mamba blocks. Parameters as the reference's:
    ``supers.mamba.*`` stacked ``[n_super, attn_every, ...]``, ``tail.*``
    ``[n_tail, ...]``, ``shared_attn.*`` once."""

    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg, "hybrid")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_super * cfg.attn_every
        self.n_ssm_heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim

    def _init_mamba(self, gen, dev) -> Tuple[dict, dict]:
        c = self.cfg
        return SSM.init_mamba2(gen, c.d_model, c.ssm_state, c.ssm_head_dim,
                               c.ssm_expand, c.d_conv, c.pdt, dev)

    # ---------------- init
    def init(self, seed: int = 0, device=None, with_axes: bool = False):
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one; ``"meta"``: shapes only);
        ``with_axes``: ``(params, axes)``."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), ("vocab", "embed"),
                scale=0.02)
        b.ones("ln_f", (c.d_model,), ("embed",))
        b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)),
                ("embed", "vocab"))

        def init_super(g):
            bb = Builder(g, c.pdt, dev)
            bb.sub("mamba", *stack_layers(
                g, c.attn_every, lambda gg: self._init_mamba(gg, dev)))
            return bb.done()

        b.sub("supers", *stack_layers(gen, self.n_super, init_super))
        if self.n_tail:
            b.sub("tail", *stack_layers(
                gen, self.n_tail, lambda g: self._init_mamba(g, dev)))
        # the SHARED attention block (one set of weights, applied n_super
        # x), dense whatever n_experts says (the reference's moe_ffn=False)
        b.sub("shared_attn", *_init_attn_block(gen, c, dev))
        return _with_axes(b.done(), with_axes)

    # ---------------- the backbone
    def _mamba(self, p, x, states=None, idx=(), fresh: bool = False):
        """One Mamba block with its residual. In cached mode its state is
        ``states[k][idx]``, read (as zero, not read, where ``fresh``: a
        new cache's) and then overwritten in place."""
        c = self.cfg
        st = None if states is None else {
            k: None if fresh else v[idx] for k, v in states.items()}
        y, ns = SSM.apply_mamba2(p, x, d_state=c.ssm_state,
                                 head_dim=c.ssm_head_dim, chunk=c.ssd_chunk,
                                 state=st, impl=c.ssm_impl,
                                 n_heads=self.n_ssm_heads)
        if states is not None:
            for k, v in ns.items():
                states[k][idx].copy_(v)
        return x + y

    def _backbone(self, params, x, positions, *, states=None, kv=None,
                  pos: int = 0):
        """``states``/``kv`` given: cached mode, both updated in place. At
        ``pos == 0`` (a prefill: the states are a new cache's zeros) a
        prompt whose shapes the SSD kernel takes starts the Mamba blocks
        from no state, so ``ssm_impl`` picks the route as for a full
        sequence: under ``"mamba_kernel"`` the kernel, where the reference
        reads its zero state and runs the plain scan (the same function).
        Any other prompt reads the zeros, as the reference."""
        c = self.cfg
        cached = states is not None
        fresh = cached and pos == 0 and kernel_takes(
            c.cdt, x.shape[1], c.ssm_head_dim, c.ssm_state, c.ssd_chunk)

        def group(xx, i):
            """Super group ``i``: its Mamba blocks, then the shared
            attention block."""
            sp = layer(params["supers"]["mamba"], i)
            for j in range(c.attn_every):
                xx = self._mamba(layer(sp, j), xx,
                                 states["supers"]["mamba"] if cached
                                 else None, (i, j), fresh)
            cache = (kv["shared"][0][i], kv["shared"][1][i]) if cached \
                else None
            return _apply_attn_block(Sh.dp_tree(params["shared_attn"]), xx,
                                     c, positions=positions, cache=cache,
                                     cache_pos=pos)[0]

        if not cached:      # the caches are written in place: no recompute
            group = _maybe_remat(group, c)
        for i in range(self.n_super):
            x = group(x, i)
        for j in range(self.n_tail):
            x = self._mamba(layer(params["tail"], j), x,
                            states["tail"] if cached else None, (j,), fresh)
        return x

    def _forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full sequence (no cache)."""
        c = self.cfg
        x = _embed(c, params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._backbone(params, x, positions)
        x = _final_norm(c, x, params["ln_f"])
        return _logits(c, x, params)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``[B, S]``): ``(loss, {"ce_loss": loss})``."""
        loss = _loss(self.cfg, self._forward(params, batch["tokens"]),
                     batch["labels"])
        return loss, {"ce_loss": loss}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, Any]:
        """Zero caches: per Mamba block a conv state ``[B, K-1, C]`` in the
        compute dtype and an SSM state ``[B, H, P, N]`` in f32, stacked as
        the parameters; the shared block's K/V ``[n_super, B, max_len, Hkv,
        Dh]`` in the compute dtype. Under an installed 'model' group that
        splits the SSM heads, ``H`` is this rank's share
        (:func:`~repro_torch.parallel.sharding.local_count`); the conv state
        stays whole."""
        c = self.cfg
        dev = resolve_device(device)
        d_inner = c.ssm_expand * c.d_model
        H = Sh.local_count(self.n_ssm_heads)
        mk = lambda *s: torch.zeros(s, dtype=c.cdt, device=dev)
        mkf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        mstate = lambda *n: {
            "conv": mk(*n, batch_size, c.d_conv - 1, d_inner + 2 * c.ssm_state),
            "ssm": mkf(*n, batch_size, H, c.ssm_head_dim, c.ssm_state)}
        states = {"supers": {"mamba": mstate(self.n_super, c.attn_every)}}
        if self.n_tail:
            states["tail"] = mstate(self.n_tail)
        shape = (self.n_super, batch_size, max_len, c.n_kv_heads, c.hd)
        kv = {"shared": (mk(*shape), mk(*shape))}
        return {"states": states, "kv": kv}

    def _with_cache(self, params, tokens: torch.Tensor, cache, pos: int):
        """Shared prefill/decode path at cache offset ``pos``, the caches
        updated in place. Returns the last position's logits [B, 1, V_pad]
        and the cache. Refused under ``use_mla``: the reference writes the
        shared block's latent into its GQA-shaped K/V cache and fails."""
        c = self.cfg
        if c.use_mla:
            raise ValueError(
                f"{c.name}: a hybrid with use_mla cannot prefill or decode: "
                "its shared K/V cache is GQA-shaped [n_super, B, max_len, "
                "n_kv_heads, head_dim], and the reference writes MLA's "
                "latent cache into it and fails with a dynamic_update_slice "
                "rank error; loss_fn and training run")
        x = _embed(c, params, tokens)
        positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
        x = self._backbone(params, x, positions, states=cache["states"],
                           kv=cache["kv"], pos=pos)
        x = _final_norm(c, x, params["ln_f"])
        logits = _logits(c, x[:, -1:], params)
        return logits, cache

    def prefill(self, params, tokens: torch.Tensor, max_len: int, ctx=None):
        """``ctx`` is taken and ignored, as the reference's is."""
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device)
        return self._with_cache(params, tokens, cache, 0)

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: int):
        return self._with_cache(params, tokens, cache, pos)


# ---------------------------------------------------------------------------
# XLSTM
# ---------------------------------------------------------------------------

class XLSTM:
    """``supers.*`` stacked ``[n_layers // 2, ...]``: ``mlstm``, ``slstm``,
    ``ln1``, ``ln2``; ``embed``, ``ln_f`` and an untied ``lm_head`` (the
    reference's tree; ``tie_embeddings`` is ignored there too)."""

    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg, "ssm")
        self.cfg = cfg
        self.n_super = cfg.n_layers // 2     # mLSTM + sLSTM pairs

    # ---------------- init
    def init(self, seed: int = 0, device=None, with_axes: bool = False):
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one; ``"meta"``: shapes only);
        ``with_axes``: ``(params, axes)``."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), ("vocab", "embed"),
                scale=0.02)
        b.ones("ln_f", (c.d_model,), ("embed",))
        b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)),
                ("embed", "vocab"))

        def init_super(g):
            bb = Builder(g, c.pdt, dev)
            bb.sub("mlstm", *XL.init_mlstm(g, c.d_model, c.n_heads, c.pdt,
                                           dev))
            bb.sub("slstm", *XL.init_slstm(g, c.d_model, c.n_heads, c.pdt,
                                           dev))
            bb.ones("ln1", (c.d_model,), ("embed",))
            bb.ones("ln2", (c.d_model,), ("embed",))
            return bb.done()

        b.sub("supers", *stack_layers(gen, self.n_super, init_super))
        return _with_axes(b.done(), with_axes)

    # ---------------- the backbone
    def _backbone(self, params, x, states=None):
        """``states`` given (cached mode): super block ``i`` starts from
        ``states``' entry ``i`` and writes its new states there in place."""
        c = self.cfg
        cached = states is not None
        # the blocks' parameters unbound once: each block's gradient then
        # joins the stacked leaves in one stack, where a selected block's
        # backward writes a zero tensor of the whole stack
        blocks = unstack(params["supers"], self.n_super)

        def body(xx, i):
            lp = Sh.dp_tree(blocks[i])
            st = layer(states, i) if cached else {"m": None, "s": None}
            y, nm = XL.apply_mlstm(lp["mlstm"],
                                   rms_norm(xx, lp["ln1"], c.norm_eps),
                                   state=st["m"], q_chunk=c.attn_q_chunk,
                                   n_heads=c.n_heads)
            xx = xx + y
            y, ns = XL.apply_slstm(lp["slstm"],
                                   rms_norm(xx, lp["ln2"], c.norm_eps),
                                   state=st["s"], n_heads=c.n_heads)
            if cached:
                for kind, new in (("m", nm), ("s", ns)):
                    for k, v in new.items():
                        st[kind][k].copy_(v)
            return xx + y

        if not cached:      # the caches are written in place: no recompute
            body = _maybe_remat(body, c)
        for i in range(self.n_super):
            x = body(x, i)
        return x

    def _forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full sequence (no cache: the
        mLSTM's chunkwise form)."""
        c = self.cfg
        x = self._backbone(params, _embed(c, params, tokens))
        x = _final_norm(c, x, params["ln_f"])
        return _logits(c, x, params)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``[B, S]``): ``(loss, {"ce_loss": loss})``."""
        loss = _loss(self.cfg, self._forward(params, batch["tokens"]),
                     batch["labels"])
        return loss, {"ce_loss": loss}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, Any]:
        """The recurrent states, stacked ``[n_super, ...]``: the mLSTM's
        ``C [.., B, H, hd, hd]`` and ``n [.., B, H, hd]`` zero in the
        compute dtype and ``m [.., B, H]`` -1e30 in f32; the sLSTM's ``c``,
        ``n``, ``h``, ``m`` ``[.., B, H, hd]`` f32 at its initial state.
        ``max_len`` is unused: the state does not grow. Under an installed
        'model' group that splits the heads, ``H`` is this rank's share
        (:func:`~repro_torch.parallel.sharding.local_count`)."""
        c = self.cfg
        dev = resolve_device(device)
        H, hd, n = (Sh.local_count(c.n_heads), c.d_model // c.n_heads,
                    self.n_super)

        def full(shape, value, dtype=torch.float32):
            return torch.full((n, batch_size) + shape, value, dtype=dtype,
                              device=dev)

        return {"m": {"C": full((H, hd, hd), 0.0, c.cdt),
                      "n": full((H, hd), 0.0, c.cdt),
                      "m": full((H,), -1e30)},
                "s": {"c": full((H, hd), 0.0), "n": full((H, hd), 1e-6),
                      "h": full((H, hd), 0.0), "m": full((H, hd), -1e30)}}

    def _with_cache(self, params, tokens: torch.Tensor, cache):
        """The step recurrence over ``tokens`` from the cache's states, which
        it overwrites in place. Returns the last position's logits [B, 1,
        V_pad] and the cache."""
        c = self.cfg
        x = _embed(c, params, tokens)
        x = self._backbone(params, x, states=cache)
        x = _final_norm(c, x[:, -1:], params["ln_f"])
        logits = _logits(c, x, params)
        return logits, cache

    def prefill(self, params, tokens: torch.Tensor, max_len: int, ctx=None):
        """``ctx`` and ``max_len`` are taken and ignored, as the reference's
        are."""
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device)
        return self._with_cache(params, tokens, cache)

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: int):
        """``pos`` is unused: the state holds the position."""
        return self._with_cache(params, tokens, cache)


# ---------------------------------------------------------------------------
# EncDec (seamless-m4t): audio-frontend stub -> encoder; text decoder
# ---------------------------------------------------------------------------

class EncDec:
    """``encoder.*`` stacked ``[n_enc_layers, ...]`` (``ln1``, ``ln2``,
    ``attn`` GQA, ``ffn`` SwiGLU), ``decoder.*`` ``[n_dec_layers, ...]``
    (``ln1``, ``ln2``, ``ln3``, ``self`` GQA, ``cross`` over the encoder's
    output, ``ffn``), ``embed``, ``ln_enc``, ``ln_dec``, an untied
    ``lm_head``: the reference's tree (``mlp_type`` and ``tie_embeddings``
    are ignored there too)."""

    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg, "audio")
        self.cfg = cfg

    # ---------------- init
    def init(self, seed: int = 0, device=None, with_axes: bool = False):
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one; ``"meta"``: shapes only);
        ``with_axes``: ``(params, axes)``."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), ("vocab", "embed"),
                scale=0.02)
        b.ones("ln_enc", (c.d_model,), ("embed",))
        b.ones("ln_dec", (c.d_model,), ("embed",))
        b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)),
                ("embed", "vocab"))

        def gqa(g):
            return A.init_gqa(g, c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                              c.pdt, dev)

        def init_enc(g):
            bb = Builder(g, c.pdt, dev)
            bb.ones("ln1", (c.d_model,), ("embed",))
            bb.ones("ln2", (c.d_model,), ("embed",))
            bb.sub("attn", *gqa(g))
            bb.sub("ffn", *init_swiglu(g, c.d_model, c.d_ff, c.pdt, dev))
            return bb.done()

        def init_dec(g):
            bb = Builder(g, c.pdt, dev)
            for name in ("ln1", "ln2", "ln3"):
                bb.ones(name, (c.d_model,), ("embed",))
            bb.sub("self", *gqa(g))
            bb.sub("cross", *A.init_cross(g, c.d_model, c.n_heads,
                                          c.n_kv_heads, c.hd, c.d_model,
                                          c.pdt, dev))
            bb.sub("ffn", *init_swiglu(g, c.d_model, c.d_ff, c.pdt, dev))
            return bb.done()

        b.sub("encoder", *stack_layers(gen, c.n_enc_layers, init_enc))
        b.sub("decoder", *stack_layers(gen, c.n_dec_layers, init_dec))
        return _with_axes(b.done(), with_axes)

    def _ffn(self, p, x):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                      d_ff=self.cfg.d_ff)

    # ---------------- encoder
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """``frames [B, S_enc, D]``, precomputed frontend embeddings (cast
        to the compute dtype, as the reference does) -> the encoder's output
        ``[B, S_enc, D]``: non-causal self-attention, the plain path under
        either ``attn_impl``."""
        c = self.cfg
        x = frames.to(c.cdt)
        positions = torch.arange(frames.shape[1], device=frames.device)

        def body(xx, i):
            lp = layer(params["encoder"], i)
            h = rms_norm(xx, lp["ln1"], c.norm_eps)
            att, _ = A.apply_gqa(lp["attn"], h, positions=positions,
                                 rope_theta=c.rope_theta, causal=False,
                                 impl=c.attn_impl, q_chunk=c.attn_q_chunk,
                                 n_heads=c.n_heads, n_kv_heads=c.n_kv_heads)
            xx = xx + att
            return xx + self._ffn(lp["ffn"], rms_norm(xx, lp["ln2"],
                                                      c.norm_eps))

        body = _maybe_remat(body, c)
        for i in range(c.n_enc_layers):
            x = body(x, i)
        return _final_norm(c, x, params["ln_enc"])

    # ---------------- decoder
    def _decode(self, params, tokens: torch.Tensor, enc_out, *, cache=None,
                pos: int = 0) -> torch.Tensor:
        """The decoder's final-normed hidden states ``[B, S, D]``. With a
        ``cache`` (``((k, v), (ck, cv))``, stacked per layer) the self K/V
        are written at ``pos`` in place, and the cross K/V too when
        ``enc_out`` is given (prefill); without ``enc_out`` they are read
        from it (decode)."""
        c = self.cfg
        x = _embed(c, params, tokens)
        positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
        cached = cache is not None
        kw = dict(impl=c.attn_impl, q_chunk=c.attn_q_chunk)

        def body(xx, i):
            lp = layer(params["decoder"], i)
            h = rms_norm(xx, lp["ln1"], c.norm_eps)
            att, _ = A.apply_gqa(lp["self"], h, positions=positions,
                                 rope_theta=c.rope_theta,
                                 cache=_at(cache[0], i) if cached else None,
                                 cache_pos=pos, n_heads=c.n_heads,
                                 n_kv_heads=c.n_kv_heads, **kw)
            xx = xx + att
            h2 = rms_norm(xx, lp["ln2"], c.norm_eps)
            cross = _at(cache[1], i) if cached else None
            xatt, kv = A.apply_cross(
                lp["cross"], h2, enc_out,
                kv_cache=cross if enc_out is None else None,
                n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, **kw)
            if cached and enc_out is not None:
                for dst, src in zip(cross, kv):
                    dst.copy_(src)
            xx = xx + xatt
            return xx + self._ffn(lp["ffn"], rms_norm(xx, lp["ln3"],
                                                      c.norm_eps))

        if not cached:      # the caches are written in place: no recompute
            body = _maybe_remat(body, c)
        for i in range(c.n_dec_layers):
            x = body(x, i)
        return _final_norm(c, x, params["ln_dec"])

    def _forward(self, params, tokens: torch.Tensor,
                 frames: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full target sequence."""
        x = self._decode(params, tokens, self.encode(params, frames))
        return _logits(self.cfg, x, params)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` given ``batch["frames"]``: ``(loss, {"ce_loss":
        loss})``."""
        loss = _loss(self.cfg,
                     self._forward(params, batch["tokens"], batch["frames"]),
                     batch["labels"])
        return loss, {"ce_loss": loss}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int, device=None,
                   n_ctx: Optional[int] = None):
        """Zero caches in the compute dtype: the decoder's self K/V ``(k, v)
        [L, B, max_len, Hkv, Dh]`` and cross K/V ``(ck, cv) [L, B, n_ctx,
        Hkv, Dh]`` (``n_ctx``: the config's unless given; under an
        installed 'model' group that splits the KV heads the cross K/V hold
        this rank's, :func:`~repro_torch.parallel.sharding.local_count`)."""
        c = self.cfg
        dev = resolve_device(device)

        def mk(length, kv_heads):
            shape = (c.n_dec_layers, batch_size, length, kv_heads, c.hd)
            return tuple(torch.zeros(shape, dtype=c.cdt, device=dev)
                         for _ in range(2))

        return (mk(max_len, c.n_kv_heads),
                mk(n_ctx or c.n_ctx, Sh.local_count(c.n_kv_heads)))

    def _last_logits(self, params, x):
        return _logits(self.cfg, x[:, -1:], params)

    def prefill(self, params, tokens: torch.Tensor, max_len: int, ctx=None):
        """``ctx``: the frames ``[B, S_enc, D]``, encoded once; the cross
        cache holds their K/V. Returns the last position's logits [B, 1,
        V_pad] and the cache."""
        if ctx is None:
            raise ValueError(f"{self.cfg.name}: the encoder-decoder's "
                             "prefill needs the frames as ctx")
        enc_out = self.encode(params, ctx)
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device,
                                n_ctx=ctx.shape[1])
        x = self._decode(params, tokens, enc_out, cache=cache, pos=0)
        return self._last_logits(params, x), cache

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: int):
        x = self._decode(params, tokens, None, cache=cache, pos=pos)
        return self._last_logits(params, x), cache


# ---------------------------------------------------------------------------

def get_model(cfg: ModelConfig):
    """The model of ``cfg``; raises ``ValueError`` for an unknown family,
    for what the reference cannot run (MLA under ``attn_impl="flash"``,
    MLA in a super block) or asserts against (a hybrid, VLM or
    encoder-decoder config without its family's fields). The hybrid with
    MLA is built and trains; its ``prefill`` and ``decode_step`` raise
    ``ValueError``, as the reference fails in its prefill."""
    if cfg.family in _DECODER_FAMILIES:
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        return HybridSSM(cfg)
    if cfg.family == "ssm":
        return XLSTM(cfg)
    if cfg.family == "audio":
        return EncDec(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# tensor and expert parallelism: the leaves that stay in their 'model' block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _leaf_axes(cfg: ModelConfig) -> Dict[Tuple[str, ...], tuple]:
    """``{path: (logical axes, shape)}`` of ``cfg``'s parameters (a meta
    init)."""
    shapes, axes = get_model(cfg).init(0, device="meta", with_axes=True)
    return {p: (a, tuple(t.shape)) for (p, a), (_, t) in
            zip(tree_items(axes), tree_items(shapes))}


def model_parallel_leaf(model, path: Tuple[str, ...], size: int) -> bool:
    """Whether the leaf at ``path`` (its keys) of ``model``'s parameters
    stays in its 'model' block on a 'model' axis of ``size`` ranks: exactly
    where the reference's rules (``BASE_RULES``) give its spec a 'model'
    dim, since every layer then computes on its block (a routed expert
    whose experts the axis does not divide, on its block of their mlp
    width). A path that names no leaf is whole."""
    leaves = _leaf_axes(model.cfg)
    if tuple(path) not in leaves:
        return False
    names, shape = leaves[tuple(path)]
    spec = Sh.spec_for_axes(names, shape, Sh.MeshShape(("model",), (size,)),
                            Sh.make_rules())
    return Sh.model_dim(spec) is not None
