"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig
(mirrors :mod:`repro.configs`, for the architectures ported so far)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
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
