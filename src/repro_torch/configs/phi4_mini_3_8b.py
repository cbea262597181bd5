"""Phi-4-mini 3.8B [arXiv:2412.08905]: dense, RoPE, SwiGLU, GQA."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=1e4,
)
SMOKE = reduced(CONFIG)
