"""AdamW and its learning-rate schedules (mirrors :mod:`repro.optim.adamw`).

Parameters, gradients and moments are nested dicts of tensors with one
structure. ``moment_dtype`` keeps the moments in f32 or bf16; every update
is computed in f32 and cast back to each tensor's dtype, as in the
reference. The reference's tree functions see a dict's leaves in sorted-key
order (:func:`repro_torch.models.common.tree_leaves`), and
:func:`global_norm` sums them in that order, so the clip factor agrees
with the reference's to the last bits the per-leaf sums allow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), f32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((s - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        # the cosine of the f32 angle in f64, rounded to f32: torch's f32
        # cos misses the correctly rounded value by an ulp where XLA's hits
        decay = (1.0 - frac if cfg.schedule == "linear" else 0.5 * (
            1.0 + torch.cos((math.pi * frac).double()).float()))
    return cfg.lr * warm * decay


def init_opt_state(cfg: AdamWConfig, params) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    some = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state, gnorm=None):
    """One AdamW step. Returns ``(new_params, new_opt_state, metrics)``;
    a new parameter requires grad where its old one did. ``gnorm`` is the
    norm the step clips by, ``global_norm(grads)`` unless given (a sharded
    step updates its shards by the whole gradient's norm)."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * g32 * g32
        upd32 = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        p_new = p32 - lr * (upd32 + decay * p32)
        return (p_new.to(p.dtype).requires_grad_(p.requires_grad),
                m32.to(m.dtype), v32.to(v.dtype))

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda p, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
