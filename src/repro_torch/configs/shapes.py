"""Assigned input shapes (LM-family: seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), not ``train_step``. ``long_500k`` requires sub-quadratic
attention: it runs only for the SSM/hybrid archs (zamba2, xlstm); pure
full-attention archs record an explicit SKIP (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# families allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def cell_supported(family: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and family not in SUBQUADRATIC_FAMILIES:
        return False, ("SKIP: full quadratic attention at 524288 tokens "
                       "(sub-quadratic archs only; DESIGN.md §6)")
    return True, ""
