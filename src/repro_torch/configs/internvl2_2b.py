"""InternVL2-2B [arXiv:2404.16821]: InternViT frontend (STUB: precomputed
patch embeddings per the brief) + InternLM2 LM backbone."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,
    n_patches=256,
)
SMOKE = reduced(CONFIG)
