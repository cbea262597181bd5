"""Gemma3-12B [hf:google/gemma-3 family]: 5 local(1024-window):1 global
attention pattern, qk-norm, dual rope theta."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1e4,           # local layers
    global_rope_theta=1e6,    # global layers
    qk_norm=True,
    sliding_window=1024,
    local_global_ratio=5,
    tie_embeddings=True,
)
SMOKE = reduced(CONFIG)
