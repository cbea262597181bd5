"""Qwen2.5-32B [hf:Qwen/Qwen2.5 family]: dense GQA with QKV bias."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    rope_theta=1e6,
    qkv_bias=True,
)
SMOKE = reduced(CONFIG)
