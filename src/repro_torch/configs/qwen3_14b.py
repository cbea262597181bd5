"""Qwen3-14B [hf:Qwen/Qwen3 family]: dense GQA with qk-norm."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
)
SMOKE = reduced(CONFIG)
