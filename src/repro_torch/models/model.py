"""Family dispatch: build a Model from a ModelConfig (dense with gemma3's
local/global pattern, MoE, VLM and hybrid so far)."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .common import Model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        from . import hybrid
        return hybrid.build(cfg)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    from . import transformer
    return transformer.build(cfg)
