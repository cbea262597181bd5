"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder; conv/mel frontend is a
STUB (input_specs provides precomputed 1500-frame embeddings)."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
)
SMOKE = reduced(CONFIG)
