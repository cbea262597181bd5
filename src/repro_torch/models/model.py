"""Family dispatch: build a Model from a ModelConfig (dense only so far)."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .common import Model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.local_global_ratio:
        raise NotImplementedError("local/global attention (gemma3) is not ported yet")
    from . import transformer
    return transformer.build(cfg)
