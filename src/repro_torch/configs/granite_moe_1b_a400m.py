"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32 experts, top-8."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                # per-expert FFN width
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    tie_embeddings=True,
)
SMOKE = reduced(CONFIG)
