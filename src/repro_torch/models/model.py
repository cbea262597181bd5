"""Family dispatch: build a Model from a ModelConfig. Every family that
``repro`` builds is built here: dense (with gemma3's local/global
pattern), MoE and VLM through ``transformer``, the Mamba2 hybrid, the xLSTM
(``"ssm"``) and the Whisper encoder-decoder (``"audio"``); and, beyond
``repro``, Zamba2-7B (``"zamba2"``, training only)."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .common import Model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        from . import hybrid
        return hybrid.build(cfg)
    if cfg.family == "zamba2":
        from . import zamba2
        return zamba2.build(cfg)
    if cfg.family == "ssm":
        from . import xlstm_model
        return xlstm_model.build(cfg)
    if cfg.family == "audio":
        from . import encdec
        return encdec.build(cfg)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    from . import transformer
    return transformer.build(cfg)
