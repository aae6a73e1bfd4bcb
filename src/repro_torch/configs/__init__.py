"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig + input
specs (mirrors :mod:`repro.configs`: its ten architectures).

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
    "llama-3.2-vision-90b": "repro_torch.configs.llama3_2_vision_90b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
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

    A train batch of the VLM carries ``ctx [B, n_ctx, d_ctx]`` and of the
    audio model ``frames [B, S // 4, d_model]``, a prefill ``ctx [B, n_ctx,
    d_ctx | d_model]``, all in the compute dtype, as the reference's. The
    decode cache is the port's own ``init_cache(B, S, device="meta")``: the
    same leaves as the reference's (``{"stage<i>": (k, v)}``, MLA's
    latents, a super block's dict, the hybrid's conv/SSM states and shared
    K/V, the encoder-decoder's self and cross K/V, the xLSTM's recurrent
    states), which the port writes in
    place where the reference returns updated copies. ``pos`` is a Python
    int in the port's steps; its stand-in keeps the reference's 0-d
    int32."""
    B, S = shape.global_batch, shape.seq_len
    i32, cdt = torch.int32, cfg.cdt
    if shape.kind == "train":
        batch = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        if cfg.family == "vlm":
            batch["ctx"] = _meta((B, cfg.n_ctx, cfg.d_ctx), cdt)
        if cfg.family == "audio":
            batch["frames"] = _meta((B, S // 4, cfg.d_model), cdt)
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), i32)}
        if cfg.family == "vlm":
            out["ctx"] = _meta((B, cfg.n_ctx, cfg.d_ctx), cdt)
        if cfg.family == "audio":
            out["ctx"] = _meta((B, cfg.n_ctx, cfg.d_model), cdt)
        return out
    # decode: one new token against a cache holding S entries
    return {"tokens": _meta((B, 1), i32),
            "cache": get_model(cfg).init_cache(B, S, device="meta"),
            "pos": _meta((), i32)}


def param_specs(cfg: ModelConfig):
    """``(meta parameter tree, logical axes tree)``: shapes and dtypes, no
    memory, and the reference's axes tree (a tuple of logical axis names
    per leaf), which :mod:`repro_torch.parallel.sharding` maps onto a
    mesh."""
    return get_model(cfg).init(0, device="meta", with_axes=True)
