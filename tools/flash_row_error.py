#!/usr/bin/env python3
"""The bf16 flash kernel's row error, against attention in f64.

    python3 tools/flash_row_error.py [--out DIR]

``chip_smoke.py`` phase 5 holds the bf16 kernel to 1e-2 of each output
row's ``||got - want|| / ||want||`` against the plain version
(``kernels.ref.flash_attention_ref``); its CPU test,
``tests/test_torch_flash_attention.py::test_bf16_fma_fold_and_row_error``,
holds :func:`emulate_bf16_kernel` (the kernel's arithmetic in f32 on the
CPU) to the same gate. Against the plain version the two read different
rows, each rounded to bf16 by both sides. This script reads the same rows
against one exact answer: for each of the CPU test's shapes and its seeded
inputs (numpy ``default_rng(S + H + D + 1)``, standard normal, rounded to
bf16), causal, the largest row-relative error against attention computed
in f64 from the same bf16 inputs of

- the kernel (on the card),
- the plain version, on the card and on the CPU,
- the emulation (on the CPU),

and beside them the two numbers the gates read: kernel vs plain (card) and
emulation vs plain (CPU). Then phase 5's grid, case by case with phase 5's
generator: the case where kernel vs plain is largest, and there the kernel
and the plain version each against f64. Prints one line per case and
writes ``flash_row_error.json`` under ``build/bench/`` (``--out DIR``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the CPU row-error test's shapes: (B, S, H, Hkv, D)
EMULATION_SHAPES = ((1, 1024, 32, 8, 64), (1, 2048, 32, 32, 64),
                    (4, 1024, 4, 2, 128))


def make_qkv(seed, B, S, H, Hkv, D):
    """The CPU tests' inputs (``tests/test_torch_flash_attention.py``)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def emulate_bf16_kernel(q, k, v, causal, block_k=128, fold=True):
    """The arithmetic of the bf16 kernel in ``csrc/flash_attention.cu``,
    in f32 on the CPU: scores of the bf16 inputs in f32, an online softmax
    over 128-key tiles (the -1e30 mask and the running max on the unscaled
    scores, exp2 of the scores scaled by ``log2(e) / sqrt(D)``), P split
    into bf16 hi + lo and both products accumulated in f32, then
    ``acc / max(l, 1e-20)`` rounded to bf16. ``fold``: the exponent as the
    kernel computes it, one FMA ``fmaf(s, sl2, -m sl2)`` (the product
    exact, one rounding); without it, ``s sl2`` is rounded before the
    subtraction."""
    import torch
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                            # [B,H,S,D]
    kf = k.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    sl2 = np.float32(1.0 / np.sqrt(D)) * np.float32(1.4426950408889634)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        keys = torch.arange(k0, min(S, k0 + block_k))[None, :]
        x = qf @ kf[:, :, k0:k0 + block_k].transpose(2, 3)
        if causal:
            x = torch.where(keys > rows, torch.tensor(-1e30), x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * sl2)
        msl = m_new * sl2
        if fold:
            p = torch.exp2((x.double() * float(sl2) - msl.double()).float())
        else:
            p = torch.exp2(x * sl2 - msl)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vf[:, :, k0:k0 + block_k]
        acc = acc * alpha + hi @ vt + lo @ vt
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)
    return out.permute(0, 2, 1, 3).bfloat16()


def attention_f64(q, k, v, causal):
    """Attention of the (bf16) inputs computed in f64, head by head."""
    import torch
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    out = torch.empty((B, S, H, D), dtype=torch.float64, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    for h in range(H):
        qh = q[:, :, h].double()
        kh, vh = k[:, :, h // rep].double(), v[:, :, h // rep].double()
        s = qh @ kh.transpose(1, 2) / np.sqrt(D)
        if causal:
            s = s.masked_fill(~mask, -np.inf)
        out[:, :, h] = torch.softmax(s, -1) @ vh
    return out


def row_rel(got, want):
    """The largest ||got - want|| / ||want|| over the output's rows."""
    got, want = got.double(), want.double().to(got.device)
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-300)).max())


def card_line() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]


def emulation_rows(torch, flash_attention, flash_attention_ref):
    out = []
    for B, S, H, Hkv, D in EMULATION_SHAPES:
        t0 = time.perf_counter()
        q, k, v = (torch.from_numpy(a).bfloat16()
                   for a in make_qkv(S + H + D + 1, B, S, H, Hkv, D))
        qc, kc, vc = (x.cuda() for x in (q, k, v))
        exact = attention_f64(qc, kc, vc, True)
        kern = flash_attention(qc, kc, vc, causal=True)
        plain_card = flash_attention_ref(qc, kc, vc, causal=True)
        plain_cpu = flash_attention_ref(q, k, v, causal=True)
        emu = emulate_bf16_kernel(q, k, v, True)
        rec = dict(shape=[B, S, H, Hkv, D], rows=B * S * H,
                   kernel_vs_f64=row_rel(kern, exact),
                   plain_card_vs_f64=row_rel(plain_card, exact),
                   plain_cpu_vs_f64=row_rel(plain_cpu.cuda(), exact),
                   emulation_vs_f64=row_rel(emu.cuda(), exact),
                   kernel_vs_plain=row_rel(kern, plain_card),
                   emulation_vs_plain=row_rel(emu, plain_cpu),
                   differ_from_emulation=float(
                       (kern.cpu().float() != emu.float()).float().mean()),
                   secs=time.perf_counter() - t0)
        print(f"flash_row_error {tuple(rec['shape'])} causal, {rec['rows']} "
              f"rows: vs f64 kernel {rec['kernel_vs_f64']:.6f}, emulation "
              f"{rec['emulation_vs_f64']:.6f}, plain card "
              f"{rec['plain_card_vs_f64']:.6f}, plain CPU "
              f"{rec['plain_cpu_vs_f64']:.6f}; kernel vs plain "
              f"{rec['kernel_vs_plain']:.6f}, emulation vs plain "
              f"{rec['emulation_vs_plain']:.6f}; outputs differing from "
              f"the emulation {100 * rec['differ_from_emulation']:.4f} %",
              flush=True)
        out.append(rec)
    return out


def grid_worst(torch, flash_attention, flash_attention_ref):
    """Phase 5's bf16 grid, with phase 5's generator: the case where the
    kernel's row error against the plain version is largest."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = [(B, S, H, Hkv, D) for B in cs.FLASH_B for S in cs.FLASH_S
              for H, Hkv in cs.FLASH_HEADS for D in cs.FLASH_D]
    worst = None
    for B, S, H, Hkv, D in shapes + list(cs.FLASH_EXTRA):
        for dt in cs.FLASH_TOL:         # the generator's draws, in order
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                       .to(getattr(torch, dt)) for h in (H, Hkv, Hkv))
            if dt != "bfloat16":
                continue
            for causal in (True, False):
                kern = flash_attention(q, k, v, causal=causal)
                plain = flash_attention_ref(q, k, v, causal=causal)
                rel = row_rel(kern, plain)
                if worst is None or rel > worst["kernel_vs_plain"]:
                    exact = attention_f64(q, k, v, causal)
                    worst = dict(shape=[B, S, H, Hkv, D], causal=causal,
                                 rows=B * S * H, kernel_vs_plain=rel,
                                 kernel_vs_f64=row_rel(kern, exact),
                                 plain_vs_f64=row_rel(plain, exact))
    print(f"flash_row_error grid: largest kernel vs plain "
          f"{worst['kernel_vs_plain']:.6f} at {tuple(worst['shape'])} "
          f"causal={worst['causal']} ({worst['rows']} rows); there vs f64 "
          f"kernel {worst['kernel_vs_f64']:.6f}, plain "
          f"{worst['plain_vs_f64']:.6f}", flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "bench"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_row_error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"flash_row_error: card {card}, torch {torch.__version__}",
          flush=True)
    rec = dict(card=card,
               emulation_shapes=emulation_rows(torch, flash_attention,
                                               flash_attention_ref),
               grid_worst=grid_worst(torch, flash_attention,
                                     flash_attention_ref))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_row_error.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
