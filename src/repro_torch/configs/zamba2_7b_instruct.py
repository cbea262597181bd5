"""Zamba2-7B-Instruct as published (huggingface.co/Zyphra/Zamba2-7B-Instruct,
config.json; arXiv:2411.15242), family ``"zamba2"``: 81 Mamba2 layers with
2 B/C groups, and two shared attention+MLP blocks used in turn before the 13
layers of ``hybrid_layer_ids``, reading the residual stream concatenated with
the embedding (attention 7168 -> 32 heads of 224, scale (224/2)^-1/2), a
gated-GELU MLP with a rank-128 adapter a site. The SSD runs in chunks of 128
(the published 256 blocks the same recurrence; the port's kernels take
Q <= 128). The embedding is tied to the output projection (transformers'
default; the config does not say)."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b-instruct",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10000.0,
    attn_in=7168,
    attn_scale_div=2,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    ssm_groups=2,
    n_shared_blocks=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    adapter_rank=128,
    norm_eps=1e-5,
    tie_embeddings=True,
)
# d 128, 2 groups, both shared blocks used twice inside 8 layers, chunk 32
SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-7b-instruct-smoke", n_layers=8, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=64, attn_in=256, d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=32,
    ssm_chunk=32, hybrid_layer_ids=(1, 3, 5, 7), adapter_rank=8, dtype="float32")
