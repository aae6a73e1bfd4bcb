"""How far xlstm-125m's prefill logits move when every weight is moved by
a relative 1e-7 (about an f32 rounding), at full width in f32, after 16,
32, 64 and 128 prompt tokens: with the reference's init, whose sLSTM
recurrent matrices ``r [H, hd, hd]`` are drawn at 1 / sqrt(H), and with
them rescaled to 1 / sqrt(hd) (as ``chip_smoke.py`` 21(b) and 27(d) do).
Prints, per length, the largest ``||a - b|| / ||a||`` over the last
position's rows: how much any two ways of summing the same model (one
device against another, a mesh against none) can differ there.

    PYTHONPATH=src python3 tools/xlstm_sensitivity.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.transformer import get_model  # noqa: E402

LENGTHS = (16, 32, 64, 128)
NUDGE = 1e-7


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = configs.get_config("xlstm-125m", param_dtype="float32",
                             compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(args.seed, args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, LENGTHS[-1]), generator=gen,
                         device=args.device, dtype=torch.int32)

    def last_logits(p, n):
        with torch.no_grad():
            logits, _ = model.prefill(p, toks[:, :n], max_len=n + 1)
        return logits[:, -1].double()

    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    for name in ("the reference's init", "r at 1 / sqrt(hd)"):
        if name != "the reference's init":
            for g in "ifzo":
                params["supers"]["slstm"][f"r{g}"].mul_((H / hd) ** 0.5)
        for n in LENGTHS:
            a = last_logits(params, n)
            nudged = tree_map(lambda t: t * (1 + NUDGE * torch.randn(
                t.shape, generator=gen, device=t.device)), params)
            b = last_logits(nudged, n)
            rel = float(((a - b).norm(dim=-1) / a.norm(dim=-1)).max())
            print(f"{name}: {n} tokens: {rel:.3g} (finite "
                  f"{bool(torch.isfinite(a).all())})", flush=True)


if __name__ == "__main__":
    main()
