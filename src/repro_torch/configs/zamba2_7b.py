"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone with a weight-shared
attention+MLP block applied every 6 mamba layers."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
)
SMOKE = reduced(CONFIG)
