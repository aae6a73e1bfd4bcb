"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig + input
specs (mirrors :mod:`repro.configs`, for the architectures ported so far).

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device in place
of the reference's ``jax.ShapeDtypeStruct`` stand-ins: shapes and dtypes of
every input of the cell's step (train / prefill / decode), no memory.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: F401
                                        cell_supported)
from repro_torch.models.transformer import ModelConfig, get_model

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
}

ARCHS = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown or unported arch {arch!r}; the port has "
                         f"{ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, **overrides) -> ModelConfig:
    return _module(arch).config(**overrides)


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    """The reduced config of ``arch``, with ``overrides`` applied."""
    return dataclasses.replace(_module(arch).smoke(), **overrides)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """Meta-tensor stand-ins for the step inputs of one cell.

    The decode cache is the port's own ``init_cache(B, S, device="meta")``:
    the same leaves as the reference's (``{"stage<i>": (k, v)}``, MLA's
    latents, a super block's dict, and the hybrid's conv/SSM states and
    shared K/V), which the port writes in
    place where the reference returns updated copies. ``pos`` is a Python
    int in the port's steps; its stand-in keeps the reference's 0-d int32.
    The vlm and audio inputs belong to families the port has not got."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        return {"batch": {"tokens": _meta((B, S), i32),
                          "labels": _meta((B, S), i32)}}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against a cache holding S entries
    return {"tokens": _meta((B, 1), i32),
            "cache": get_model(cfg).init_cache(B, S, device="meta"),
            "pos": _meta((), i32)}


def param_specs(cfg: ModelConfig):
    """``(meta parameter tree, None)``: shapes and dtypes, no memory. The
    reference's second element, the logical sharding axes, has no meaning
    on one card."""
    return get_model(cfg).init(0, device="meta"), None
