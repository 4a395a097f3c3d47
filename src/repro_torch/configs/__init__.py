"""Architecture registry of the port (the architectures it serves)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPE_CELLS, ModelConfig, ShapeCell

_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
            "olmoe-1b-7b": "olmoe_1b_7b",
            "starcoder2-15b": "starcoder2_15b",
            "chatglm3-6b": "chatglm3_6b",
            "deepseek-7b": "deepseek_7b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "rwkv6-3b": "rwkv6_3b",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "seamless-m4t-large-v2": "seamless_m4t_large_v2",
            "internvl2-26b": "internvl2_26b"}

ARCH_NAMES = tuple(_MODULES)

_MODULE_TO_ARCH = {v: k for k, v in _MODULES.items()}


def canonical_arch(name: str) -> str:
    """Registry id for ``name``, accepting module-style spellings too
    (``tinyllama_1_1b`` == ``tinyllama-1.1b``)."""
    if name in _MODULES:
        return name
    if name in _MODULE_TO_ARCH:
        return _MODULE_TO_ARCH[name]
    raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[canonical_arch(name)]}")


def get_config(name: str, quant="none", gs: int = 2, n_p: int = 8):
    """Full published config, optionally with the paper's PSUM
    quantization: ``quant`` is a preset (``"none"``, ``"w8a8"``,
    ``"psq"``, ``"apsq"``; ``gs`` and ``n_p`` for the PSUM presets), a
    ``QuantConfig`` or a per-layer ``QuantPolicy``."""
    from repro_torch.core import QuantConfig
    cfg = _module(name).CONFIG
    if isinstance(quant, str):
        presets = {"none": None, "apsq": QuantConfig.apsq(gs=gs, n_p=n_p),
                   "psq": QuantConfig.psq(n_p=n_p),
                   "w8a8": QuantConfig.w8a8()}
        if quant not in presets:
            raise KeyError(f"unknown quant preset {quant!r}; "
                           f"known: {sorted(presets)}")
        quant = presets[quant]
    if quant is not None:
        cfg = cfg.with_quant(quant)
    return cfg.validate()


def get_smoke(name: str):
    return _module(name).smoke_config().validate()


def cells_for(name: str) -> dict:
    """The assigned shape cells runnable for this arch: ``long_500k`` only
    for sub-quadratic archs (no full-attention layer)."""
    cells = {k: v for k, v in SHAPE_CELLS.items() if k != "long_500k"}
    if get_config(name).sub_quadratic:
        cells["long_500k"] = SHAPE_CELLS["long_500k"]
    return cells


__all__ = ["ARCH_NAMES", "SHAPE_CELLS", "ModelConfig", "ShapeCell",
           "canonical_arch", "cells_for", "get_config", "get_smoke"]
