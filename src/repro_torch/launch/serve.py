"""Serving launcher: batched generation with the ServingEngine (mirrors
:mod:`repro.launch.serve`), on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 1024 --new-tokens 32

runs the full-width model with random weights from ``--seed``; ``--smoke``
takes the reduced config, and ``--device cpu`` runs on the CPU.

The attention of the prefill defaults to ``"flash"`` (the hand-written
kernel) where the reference's configs default to ``"xla"``: the port's
plain path materialises the ``[B, H, S, S]`` f32 scores, and its reason to
exist is the kernel. ``--attn-impl xla`` takes the plain path.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs as CN
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import get_model
from repro_torch.serving.engine import ServeConfig, ServingEngine


def run_serving(arch: str, *, batch: int, prompt_len: int, new_tokens: int,
                smoke: bool = True, temperature: float = 0.0,
                attn_impl: str = "flash", device=None, seed: int = 0) -> dict:
    """Generate ``new_tokens`` for ``batch`` random prompts of
    ``prompt_len`` tokens with random weights (both from ``seed``)."""
    dev = resolve_device(device)
    get = CN.get_smoke_config if smoke else CN.get_config
    cfg = get(arch, attn_impl=attn_impl)
    model = get_model(cfg)
    params = model.init(seed, dev)
    engine = ServingEngine(
        cfg, ServeConfig(batch=batch, max_len=prompt_len + new_tokens + 1,
                         temperature=temperature), params=params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = random_prompts(cfg.vocab_size, batch, prompt_len, gen)
    out = engine.generate(prompts, new_tokens,
                          generator=gen if temperature > 0 else None)
    st = engine.last_stats
    wall = st["prefill_s"] + st["decode_s"]
    return {
        "arch": arch,
        "attn_impl": attn_impl,
        "device": str(dev),
        "n_params": sum(p.numel() for p in tree_leaves(params)),
        "generated_shape": list(out.shape),
        "prefill_s": st["prefill_s"],
        "decode_tokens_per_s": (batch * (new_tokens - 1) / st["decode_s"]
                                if new_tokens > 1 else 0.0),
        "tokens_per_s": batch * new_tokens / wall,
        "wall_s": wall,
        "logits_finite": st["logits_finite"],
        "all_in_vocab": bool((out >= 0).all() and (out < cfg.vocab_size).all()),
    }


def random_prompts(vocab_size: int, batch: int, prompt_len: int,
                   gen: torch.Generator) -> torch.Tensor:
    """``[batch, prompt_len]`` int32 tokens drawn from ``gen``, on its
    device."""
    return torch.randint(0, vocab_size, (batch, prompt_len), generator=gen,
                         device=gen.device, dtype=torch.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=CN.ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--attn-impl", choices=("flash", "xla"), default="flash")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(run_serving(args.arch, batch=args.batch,
                                 prompt_len=args.prompt_len,
                                 new_tokens=args.new_tokens,
                                 smoke=args.smoke,
                                 temperature=args.temperature,
                                 attn_impl=args.attn_impl,
                                 device=args.device, seed=args.seed),
                     indent=2))


if __name__ == "__main__":
    main()
