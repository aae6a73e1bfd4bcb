"""Serving launcher: batched generation with the ServingEngine (mirrors
:mod:`repro.launch.serve`), on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 1024 --new-tokens 32

runs the full-width model with random weights from ``--seed``; ``--smoke``
takes the reduced config, ``--n-layers`` cuts the depth (the full
llama-3.2-vision-90b fits one card at 10 layers) and ``--device cpu`` runs
on the CPU. The VLM and seamless-m4t-large-v2 get a random ``ctx`` (their
frontends are stubs).

The attention of the prefill defaults to ``"flash"`` (the hand-written
kernel) where the reference's configs default to ``"xla"``: the port's
plain path materialises the ``[B, H, S, S]`` f32 scores, and its reason to
exist is the kernel. ``--attn-impl xla`` takes the plain path.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from repro_torch import configs as CN
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import get_model
from repro_torch.serving.engine import ServeConfig, ServingEngine


def run_serving(arch: str, *, batch: int, prompt_len: int, new_tokens: int,
                smoke: bool = True, temperature: float = 0.0,
                attn_impl: str = "flash", device=None, seed: int = 0,
                n_layers: Optional[int] = None) -> dict:
    """Generate ``new_tokens`` for ``batch`` random prompts of
    ``prompt_len`` tokens with random weights (both from ``seed``); the
    VLM and the encoder-decoder also take a random ``ctx``
    (:func:`random_ctx`). ``n_layers`` cuts the depth (the full VLM does
    not fit one card)."""
    dev = resolve_device(device)
    get = CN.get_smoke_config if smoke else CN.get_config
    depth = {} if n_layers is None else {"n_layers": n_layers}
    cfg = get(arch, attn_impl=attn_impl, **depth)
    model = get_model(cfg)
    params = model.init(seed, dev)
    engine = ServingEngine(
        cfg, ServeConfig(batch=batch, max_len=prompt_len + new_tokens + 1,
                         temperature=temperature), params=params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = random_prompts(cfg.vocab_size, batch, prompt_len, gen)
    ctx = random_ctx(cfg, batch, gen)
    out = engine.generate(prompts, new_tokens, ctx=ctx,
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


def random_ctx(cfg, batch: int, gen: torch.Generator):
    """The stubbed frontend's output, drawn from ``gen`` on its device in
    the compute dtype: the VLM's patches ``[batch, n_ctx, d_ctx]``, the
    encoder-decoder's frames ``[batch, n_ctx, d_model]``; ``None`` for the
    other families. (The reference's launcher draws them in f32, which a
    bf16 VLM cannot take.)"""
    width = {"vlm": cfg.d_ctx, "audio": cfg.d_model}.get(cfg.family)
    if width is None:
        return None
    return torch.randn((batch, cfg.n_ctx, width), generator=gen,
                       device=gen.device).to(cfg.cdt)


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
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (e.g. 10 for the VLM on one card)")
    args = ap.parse_args()
    print(json.dumps(run_serving(args.arch, batch=args.batch,
                                 prompt_len=args.prompt_len,
                                 new_tokens=args.new_tokens,
                                 smoke=args.smoke,
                                 temperature=args.temperature,
                                 attn_impl=args.attn_impl,
                                 device=args.device, seed=args.seed,
                                 n_layers=args.n_layers),
                     indent=2))


if __name__ == "__main__":
    main()
