"""Serving engine: prefill and decode steps with a KV cache, and batched
generation (mirrors :mod:`repro.serving.engine`, on one device).

The reference jits the two steps and shards the caches over a mesh; here
they run eagerly on one card, and the cache is updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, get_model


@dataclasses.dataclass
class ServeConfig:
    batch: int
    max_len: int
    temperature: float = 0.0   # 0 -> greedy


class ServingEngine:
    """``params`` live on ``device`` (``None``: the card, raising without
    one)."""

    def __init__(self, cfg: ModelConfig, serve_cfg: ServeConfig, params=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.model = get_model(cfg)
        self.params = params
        self.last_stats: dict = {}

    def prefill(self, tokens: torch.Tensor, ctx=None):
        """``ctx``: the VLM's patches or the encoder-decoder's frames, moved
        to the engine's device (other models ignore it)."""
        if ctx is not None:
            ctx = ctx.to(self.device)
        return self.model.prefill(self.params, tokens,
                                  max_len=self.scfg.max_len, ctx=ctx)

    def decode(self, tokens: torch.Tensor, cache, pos: int):
        return self.model.decode_step(self.params, tokens, cache, pos)

    def generate(self, prompt_tokens: torch.Tensor, n_new: int, ctx=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy (or, with a temperature and a ``generator``, sampled)
        generation for a full batch: ``[B, n_new]`` int32 tokens; ``ctx``
        goes to the prefill.

        ``last_stats`` then holds ``prefill_s`` (prompt in to the first
        token on the host: the time to first token), ``decode_s`` (the
        remaining ``n_new - 1`` tokens, up to their arrival on the host)
        and ``logits_finite`` (every sampled-from logit is finite)."""
        prompt_tokens = prompt_tokens.to(self.device)
        S = prompt_tokens.shape[1]
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompt_tokens, ctx)
        finite = torch.isfinite(logits).all()
        tok = self._sample(logits, generator)
        first = tok.cpu()
        t1 = time.perf_counter()
        outs = [tok]
        for i in range(1, n_new):
            logits, cache = self.decode(tok, cache, S + i - 1)
            finite &= torch.isfinite(logits).all()
            tok = self._sample(logits, generator)
            outs.append(tok)
        rest = torch.cat(outs[1:], dim=1).cpu() if n_new > 1 else first[:, :0]
        t2 = time.perf_counter()
        self.last_stats = dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                               logits_finite=bool(finite))
        return torch.cat([first, rest], dim=1).numpy()

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        last = logits[:, -1].float()
        if self.scfg.temperature <= 0.0 or generator is None:
            return last.argmax(-1)[:, None].to(torch.int32)
        probs = torch.softmax(last / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int,
                    device=None):
    """The one-token decode step of the decode cells, ``serve_step(params,
    tokens [batch, 1], cache, pos) -> (logits, cache)`` at ``pos <
    max_len``, with ``cache`` from ``init_cache(batch, max_len)`` on
    ``device`` (``None``: the card), written in place. On one card there
    are no shardings to return: the step comes alone, where the reference
    returns it with the cache's and the tokens' shardings."""
    resolve_device(device)
    model = get_model(cfg)

    def serve_step(params, tokens, cache, pos: int):
        if tuple(tokens.shape) != (batch, 1) or not 0 <= pos < max_len:
            raise ValueError(f"serve_step takes [{batch}, 1] tokens at a "
                             f"position below {max_len}, got "
                             f"{list(tokens.shape)} at {pos}")
        return model.decode_step(params, tokens, cache, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig, batch: int, seq: int, device=None):
    """The prefill step of the prefill cells, ``prefill_step(params, tokens
    [batch, <= seq], ctx=None) -> (logits, cache)``, its cache of ``seq``
    entries built on the tokens' device (``device`` is checked as the other
    entry points check it: ``None`` means the card); ``ctx`` is the VLM's
    patches or the encoder-decoder's frames. The step comes alone, without
    the reference's cache shardings."""
    resolve_device(device)
    model = get_model(cfg)

    def prefill_step(params, tokens, ctx=None):
        if tokens.shape[0] != batch or tokens.shape[1] > seq:
            raise ValueError(f"prefill_step takes {batch} rows of at most "
                             f"{seq} tokens, got {list(tokens.shape)}")
        return model.prefill(params, tokens, max_len=seq, ctx=ctx)

    return prefill_step
