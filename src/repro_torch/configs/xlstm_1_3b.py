"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM (matrix memory) blocks with one
sLSTM block every 8 layers; no separate FFN (projections live in-block)."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    ssm_head_dim=512,        # d_inner / n_heads = 4096 / 8... heads are config.n_heads
    slstm_period=8,
    tie_embeddings=True,
)
SMOKE = reduced(CONFIG, n_heads=4, n_kv_heads=4, ssm_head_dim=64)
