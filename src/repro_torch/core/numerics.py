"""Bit-parity numeric helpers (mirrors :mod:`repro.core.numerics`).

The engines' contract is f32 *op-for-op* equality with the reference's numpy
engine, which rounds after every operation. A backend that contracts a
product into an adjacent add/sub as one FMA (``a - b*c`` keeping the exact
product) breaks it. These helpers make the rounding point explicit:

- :func:`rounded_product` — ``b*c`` rounded to its storage dtype before any
  consumer uses it;
- :func:`fma_free_madd` / :func:`fma_free_msub` — ``a + b*c`` / ``a - b*c``
  with the product rounded first;
- :func:`guarded_denominator` — a denominator with padded/disabled rows
  mapped to 1, so a batched division never mints NaN/inf values the
  unbatched numpy mirror would not produce.

Everything takes an ``xp`` namespace argument (``numpy`` or ``torch``). In
eager PyTorch every operation is its own kernel that writes its rounded
result to memory, so the multiply and the add are two ops and the product
is already rounded: no barrier is needed (the reference wraps its JAX
product in ``lax.optimization_barrier`` because XLA fuses the two).
"""
from __future__ import annotations

import numpy as np


def rounded_product(b, c, xp=np):
    """``b * c`` rounded to the storage dtype before any downstream use
    (numpy and eager torch round every op by construction)."""
    return xp.multiply(b, c)


def fma_free_madd(a, b, c, xp=np):
    """``a + b*c`` with the product rounded first (never a fused FMA)."""
    return a + rounded_product(b, c, xp=xp)


def fma_free_msub(a, b, c, xp=np):
    """``a - b*c`` with the product rounded first (never a fused FMA)."""
    return a - rounded_product(b, c, xp=xp)


def guarded_denominator(den, enabled=None, xp=np):
    """A division-safe denominator: rows that must not divide map to 1.

    ``enabled`` masks the live rows (default ``den > 0``); the masked rows'
    quotients are junk by construction and callers select them away."""
    if enabled is None:
        enabled = den > 0
    return xp.where(enabled, den, xp.ones_like(den))
