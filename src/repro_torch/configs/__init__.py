"""Architecture registry: one module per assigned architecture.

A plain copy of `repro.configs` (data only), kept here so that the port
imports nothing of the reference package.
"""

from __future__ import annotations

from typing import Dict

from .base import SHAPES, ArchConfig, ShapeSpec, shapes_for  # noqa: F401

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        command_r_plus_104b,
        dbrx_132b,
        granite_20b,
        llama4_scout_17b_a16e,
        llama_3_2_vision_11b,
        musicgen_medium,
        qwen3_0_6b,
        qwen3_1_7b,
        recurrentgemma_2b,
        rwkv6_7b,
    )
