"""Model families of the port (mirrors :mod:`repro.models.transformer`).

``DecoderLM`` for the reference's dense plan ``[("dense", L, 0)]``:
pre-norm residual blocks of GQA self-attention and a SwiGLU MLP, with the
one stage's parameters stacked ``[L, ...]`` under ``"stage0"``, as in the
reference. It trains (``loss_fn``), serves (``prefill``, ``decode_step``)
and runs a full forward (``_forward``).

``HybridSSM`` (zamba2): a Mamba-2 backbone with ONE shared attention block
applied after every ``attn_every`` Mamba blocks, then the trailing Mamba
blocks. It runs the full-sequence forward and loss (``loss_fn``, through
the ``mamba2_scan`` kernel under ``ssm_impl="mamba_kernel"``) and serves.

A Python loop over the layers takes the place of the reference's
``lax.scan``; ``stream_unroll`` is kept as a field and means nothing here.
``remat="block"`` recomputes each block in the backward, as the
reference's ``jax.checkpoint`` does: :func:`_maybe_remat` wraps a
DecoderLM block, or a HybridSSM group of Mamba blocks and its shared
attention, in ``torch.utils.checkpoint`` when autograd records. The
kernels have no backward (``ModelConfig.attn_impl="flash"`` and
``ssm_impl="mamba_kernel"`` raise under autograd on the card, as
``jax.grad`` through the reference's kernels does), so training runs the
plain routes, the reference's defaults. The MoE, MLA, VLM, xLSTM and
encoder-decoder models are not ported yet: :func:`get_model` refuses them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (Builder, cross_entropy_loss,
                                       init_swiglu, layer, lm_head_logits,
                                       padded_vocab, rms_norm, stack_layers,
                                       swiglu, tree_leaves)

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
        """Active parameters per token: all of them, since the ported
        families have no experts."""
        return self.param_count()


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward under ``remat="block"`` while
    autograd records; ``fn`` itself otherwise. The blocks draw no random
    numbers, so no RNG state is kept for the recompute."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


# ---------------------------------------------------------------------------
# the block: GQA self-attention + SwiGLU
# ---------------------------------------------------------------------------

def _init_attn_block(gen, cfg: ModelConfig, device) -> dict:
    b = Builder(gen, cfg.pdt, device)
    b.ones("ln1", (cfg.d_model,))
    b.ones("ln2", (cfg.d_model,))
    b.sub("attn", A.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.pdt, device))
    b.sub("ffn", init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.pdt, device))
    return b.done()


def _apply_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _apply_attn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions, cache=None, cache_pos: int = 0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, new_cache = A.apply_gqa(
        p["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        cache=cache, cache_pos=cache_pos, impl=cfg.attn_impl,
        q_chunk=cfg.attn_q_chunk)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _apply_ffn(p["ffn"], h2), new_cache


def _check_ported(cfg: ModelConfig, family: str) -> None:
    """Refuses what the port has not got, and a hybrid config without its
    SSM fields (the reference asserts ``attn_every > 0``)."""
    if cfg.family != family or (family == "dense" and cfg.n_experts > 0):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family (moe/vlm plans, ssm and "
            "audio models) is not ported yet; the port has the dense plan "
            "and the hybrid")
    if cfg.use_mla or cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: MLA attention and the gelu MLP are not ported yet")
    if family == "hybrid" and (cfg.attn_every < 1 or cfg.ssm_state < 1):
        raise ValueError(f"{cfg.name}: a hybrid config needs attn_every >= 1 "
                         f"and ssm_state >= 1, got {cfg.attn_every} and "
                         f"{cfg.ssm_state}")


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    """A generator for drawing on ``dev``; on the meta device (shapes only,
    no memory) a CPU generator, which torch accepts there."""
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


# ---------------------------------------------------------------------------
# DecoderLM: the dense plan
# ---------------------------------------------------------------------------

class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg, "dense")
        self.cfg = cfg

    # ---------------- init
    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one)."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), scale=0.02)
        b.ones("ln_f", (c.d_model,))
        if not c.tie_embeddings:
            b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)))
        b.sub("stage0", stack_layers(
            gen, c.n_layers, lambda g: _init_attn_block(g, c, dev)))
        return b.done()

    def _head(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    # ---------------- forward (no cache)
    def _forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full sequence."""
        c = self.cfg
        x = params["embed"][tokens].to(c.cdt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)

        def block(xx, i):
            return _apply_attn_block(layer(params["stage0"], i), xx, c,
                                     positions=positions)[0]

        block = _maybe_remat(block, c)
        for i in range(c.n_layers):
            x = block(x, i)
        x = rms_norm(x, params["ln_f"], c.norm_eps)
        return lm_head_logits(x, self._head(params), c.vocab_size)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``[B, S]``) plus ``moe_aux_coef`` times
        the load-balance loss, which is 0 for the dense plan:
        ``(total, {"ce_loss", "aux_loss"})``, as the reference returns."""
        loss = cross_entropy_loss(self._forward(params, batch["tokens"]),
                                  batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = loss + self.cfg.moe_aux_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, Any]:
        """Zero K/V caches ``{"stage0": (k, v)}``, each
        ``[L, B, max_len, Hkv, Dh]`` in the compute dtype."""
        c = self.cfg
        shape = (c.n_layers, batch_size, max_len, c.n_kv_heads, c.hd)
        dev = resolve_device(device)
        return {"stage0": tuple(torch.zeros(shape, dtype=c.cdt, device=dev)
                                for _ in range(2))}

    def _with_cache(self, params, tokens: torch.Tensor, cache, pos: int):
        """Shared prefill/decode path: runs tokens (S >= 1) at cache offset
        ``pos``, writing the cache in place. Returns the last position's
        logits [B, 1, V_pad] and the cache."""
        c = self.cfg
        x = params["embed"][tokens].to(c.cdt)
        positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
        ck, cv = cache["stage0"]
        for i in range(c.n_layers):
            x, _ = _apply_attn_block(layer(params["stage0"], i), x, c,
                                     positions=positions,
                                     cache=(ck[i], cv[i]), cache_pos=pos)
        x = rms_norm(x, params["ln_f"], c.norm_eps)
        logits = lm_head_logits(x[:, -1:], self._head(params), c.vocab_size)
        return logits, cache

    def prefill(self, params, tokens: torch.Tensor, max_len: int):
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device)
        return self._with_cache(params, tokens, cache, 0)

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

    def _init_mamba(self, gen, dev) -> dict:
        c = self.cfg
        return SSM.init_mamba2(gen, c.d_model, c.ssm_state, c.ssm_head_dim,
                               c.ssm_expand, c.d_conv, c.pdt, dev)

    # ---------------- init
    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters from ``seed``, drawn on ``device`` (``None``:
        the card, raising without one; ``"meta"``: shapes only)."""
        c = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        b = Builder(gen, c.pdt, dev)
        b.dense("embed", (c.vocab_size, c.d_model), scale=0.02)
        b.ones("ln_f", (c.d_model,))
        b.dense("lm_head", (c.d_model, padded_vocab(c.vocab_size)))
        b.sub("supers", stack_layers(gen, self.n_super, lambda g: {
            "mamba": stack_layers(g, c.attn_every,
                                  lambda gg: self._init_mamba(gg, dev))}))
        if self.n_tail:
            b.sub("tail", stack_layers(
                gen, self.n_tail, lambda g: self._init_mamba(g, dev)))
        # the SHARED attention block (one set of weights, applied n_super x)
        b.sub("shared_attn", _init_attn_block(gen, c, dev))
        return b.done()

    # ---------------- the backbone
    def _mamba(self, p, x, states=None, idx=()):
        """One Mamba block with its residual. In cached mode its state is
        ``states[k][idx]``, read and then overwritten in place."""
        c = self.cfg
        st = None if states is None else {k: v[idx] for k, v in states.items()}
        y, ns = SSM.apply_mamba2(p, x, d_state=c.ssm_state,
                                 head_dim=c.ssm_head_dim, chunk=c.ssd_chunk,
                                 state=st, impl=c.ssm_impl)
        if states is not None:
            for k, v in ns.items():
                states[k][idx].copy_(v)
        return x + y

    def _backbone(self, params, x, positions, *, states=None, kv=None,
                  pos: int = 0):
        """``states``/``kv`` given: cached mode, both updated in place."""
        c = self.cfg
        cached = states is not None

        def group(xx, i):
            """Super group ``i``: its Mamba blocks, then the shared
            attention block."""
            sp = layer(params["supers"]["mamba"], i)
            for j in range(c.attn_every):
                xx = self._mamba(layer(sp, j), xx,
                                 states["supers"]["mamba"] if cached
                                 else None, (i, j))
            cache = (kv["shared"][0][i], kv["shared"][1][i]) if cached \
                else None
            return _apply_attn_block(params["shared_attn"], xx, c,
                                     positions=positions, cache=cache,
                                     cache_pos=pos)[0]

        if not cached:      # the caches are written in place: no recompute
            group = _maybe_remat(group, c)
        for i in range(self.n_super):
            x = group(x, i)
        for j in range(self.n_tail):
            x = self._mamba(layer(params["tail"], j), x,
                            states["tail"] if cached else None, (j,))
        return x

    def _forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V_pad] of the full sequence (no cache)."""
        c = self.cfg
        x = params["embed"][tokens].to(c.cdt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._backbone(params, x, positions)
        x = rms_norm(x, params["ln_f"], c.norm_eps)
        return lm_head_logits(x, params["lm_head"], c.vocab_size)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``[B, S]``): ``(loss, {"ce_loss": loss})``."""
        loss = cross_entropy_loss(self._forward(params, batch["tokens"]),
                                  batch["labels"])
        return loss, {"ce_loss": loss}

    # ---------------- caches
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, Any]:
        """Zero caches: per Mamba block a conv state ``[B, K-1, C]`` in the
        compute dtype and an SSM state ``[B, H, P, N]`` in f32, stacked as
        the parameters; the shared block's K/V ``[n_super, B, max_len, Hkv,
        Dh]`` in the compute dtype."""
        c = self.cfg
        dev = resolve_device(device)
        d_inner = c.ssm_expand * c.d_model
        H = d_inner // c.ssm_head_dim
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
        and the cache."""
        c = self.cfg
        x = params["embed"][tokens].to(c.cdt)
        positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
        x = self._backbone(params, x, positions, states=cache["states"],
                           kv=cache["kv"], pos=pos)
        x = rms_norm(x, params["ln_f"], c.norm_eps)
        logits = lm_head_logits(x[:, -1:], params["lm_head"], c.vocab_size)
        return logits, cache

    def prefill(self, params, tokens: torch.Tensor, max_len: int):
        cache = self.init_cache(tokens.shape[0], max_len, tokens.device)
        return self._with_cache(params, tokens, cache, 0)

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: int):
        return self._with_cache(params, tokens, cache, pos)


# ---------------------------------------------------------------------------

def get_model(cfg: ModelConfig):
    """The model of ``cfg``; raises ``NotImplementedError`` for what the
    port does not have yet."""
    if cfg.family == "hybrid":
        return HybridSSM(cfg)
    return DecoderLM(cfg)
