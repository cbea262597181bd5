"""--arch id -> config registry."""

from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeSpec, shapes_for

_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "zamba2-7b": "zamba2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma3-12b": "gemma3_12b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-14b": "qwen3_14b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_IDS = tuple(_MODULES)

# configurations the port builds beyond ``repro``'s: found by ``get_config``
# and ``get_smoke``, left out of ARCH_IDS (whose sweeps compare with ``repro``
# and serve)
_PORT_ONLY = {"zamba2-7b-instruct": "zamba2_7b_instruct"}


def _module(arch_id: str):
    mods = {**_MODULES, **_PORT_ONLY}
    if arch_id not in mods:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(mods)}")
    return importlib.import_module(f".{mods[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def cells(arch_id: str) -> tuple[tuple[ModelConfig, ShapeSpec], ...]:
    cfg = get_config(arch_id)
    return tuple((cfg, s) for s in shapes_for(arch_id))


def all_cells() -> list[tuple[str, ShapeSpec]]:
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]
