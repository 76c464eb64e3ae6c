"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Each module defines ``CONFIG`` (the exact published figures from the brief)
and ``reduced()`` (a small same-family config for CPU smoke tests), as in
the JAX package; the port builds a model for each
(:func:`repro_torch.models.model.build_model`).  :func:`all_cells` lists
every (arch, shape) cell, as the reference's dry run reads them."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import (ModelConfig, SHAPES, ShapeConfig,
                                      shape_cells)

_MODULES = {
    "granite-8b": "granite_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-base": "whisper_base",
}

ARCHS = tuple(_MODULES)

# runtime-registered configs (examples / experiments)
_RUNTIME: Dict[str, ModelConfig] = {}


def register_config(name: str, cfg: ModelConfig,
                    reduced: ModelConfig | None = None) -> None:
    """Register an ad-hoc architecture so launchers accept ``--arch name``."""
    _RUNTIME[name] = cfg
    if reduced is not None:
        _RUNTIME[name + "/reduced"] = reduced


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    if arch in _RUNTIME:
        return _RUNTIME[arch]
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch + "/reduced" in _RUNTIME:
        return _RUNTIME[arch + "/reduced"]
    if arch in _RUNTIME:
        return _RUNTIME[arch]
    return _mod(arch).reduced()


def all_cells() -> List[tuple]:
    """Every (arch, shape) dry-run cell, with skip rules applied."""
    return [(a, s) for a in ARCHS for s in shape_cells(a)]
