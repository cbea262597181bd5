"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8, qk-norm."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                # per-expert FFN width
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
)
SMOKE = reduced(CONFIG)
