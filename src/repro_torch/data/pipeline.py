"""Deterministic synthetic data pipeline (mirrors :mod:`repro.data.pipeline`).

The batch for step k is a pure function of ``(seed, k)``: reproducible
across restarts (after a crash and a restore the stream resumes at the
restored step with the same contents) and across devices. The draws come
from a CPU ``torch.Generator`` seeded from ``(seed, step)`` and the batch
is then moved to the device, so the card and the CPU train on the same
tokens. The law is the reference's: a Zipf marginal by inverse CDF, a copy
of the previous token with p = 0.3, and labels equal to the tokens rolled
by -1. The draws themselves differ from the reference's threefry stream.

A VLM batch also holds ``ctx [batch, n_ctx, d_ctx]`` (image patches) and an
audio batch ``frames [batch, seq_len // 4, d_model]``, standard normal in
bf16 as the reference's, drawn from the same step's generator after the
tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_ctx: int = 0
    d_ctx: int = 0
    family: str = "dense"
    d_model: int = 0


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for ``(seed, step)``. torch's CPU generator keeps 32
    bits of its seed, so the pair is mixed through numpy's
    ``SeedSequence`` rather than packed into one integer."""
    key = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(key))


def synth_batch(cfg: DataConfig, step: int,
                device=None) -> Dict[str, torch.Tensor]:
    """A language-like ``[batch, seq_len]`` int32 token batch and its
    next-token labels (and a VLM's ``ctx`` or an audio model's ``frames``),
    on ``device`` (``None``: the card).

    Tokens follow a Zipf-ish marginal with local repetition, so the loss
    curve is non-trivial (learnable bigram statistics)."""
    dev = resolve_device(device)
    gen = step_generator(cfg.seed, step)
    B, S, V = cfg.batch, cfg.seq_len, cfg.vocab_size
    # Zipf marginal via inverse CDF on uniform [1e-6, 1)
    u = torch.rand((B, S), generator=gen) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(float(V)))).to(torch.int32) - 1
    base = torch.clamp(ranks, 0, V - 1)
    # local repetition: with p=0.3 copy the previous token (shifted mix)
    rep = torch.rand((B, S), generator=gen) < 0.3
    tokens = torch.where(rep, torch.roll(base, 1, dims=1), base)
    labels = torch.roll(tokens, -1, dims=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm" and cfg.n_ctx:
        out["ctx"] = torch.randn((B, cfg.n_ctx, cfg.d_ctx),
                                 generator=gen).to(torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = torch.randn((B, S // 4, cfg.d_model),
                                    generator=gen).to(torch.bfloat16)
    return {k: v.to(dev) for k, v in out.items()}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synth_batch(cfg, step, device)
        step += 1
