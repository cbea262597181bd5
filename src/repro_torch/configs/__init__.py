from .base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    LONG_CONTEXT_ARCHS,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeSpec,
    reduced,
    shapes_for,
)
from .registry import ARCH_IDS, all_cells, cells, get_config, get_smoke

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "LONG_CONTEXT_ARCHS",
    "PREFILL_32K", "TRAIN_4K", "ModelConfig", "ShapeSpec", "reduced",
    "shapes_for", "ARCH_IDS", "all_cells", "cells", "get_config", "get_smoke",
]
