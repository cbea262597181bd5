"""Model/shape configuration system.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published numbers) and ``SMOKE`` (a reduced same-family
variant that runs a forward/train step on CPU). ``registry.py`` maps the
``--arch`` ids to modules.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "hybrid", "zamba2", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention details
    rope_theta: float = 1e4
    global_rope_theta: Optional[float] = None   # gemma3 global layers
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_in: Optional[int] = None               # attention's input width (default d_model)
    attn_scale_div: int = 1                     # softmax scale (hd / this)^-1/2 (zamba2: 2)
    sliding_window: Optional[int] = None        # window for local layers
    local_global_ratio: int = 0                 # gemma3: 5 (locals per global)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1                         # B/C groups (Mamba2's n_groups)
    shared_attn_every: int = 0                  # hybrid: shared attn block period

    # zamba2 (Zamba2-7B): shared blocks used in turn at the hybrid layers
    n_shared_blocks: int = 1
    hybrid_layer_ids: tuple = ()                # layers a shared block runs before
    adapter_rank: int = 0                       # per-site LoRA adapter on the MLP's gate_up

    # xLSTM
    slstm_period: int = 0                       # 1 sLSTM per this many layers

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                        # precomputed frame embeddings (stub)

    # VLM (internvl2)
    n_patches: int = 0                          # precomputed patch embeddings (stub)

    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                     # activations/params compute dtype

    def __post_init__(self) -> None:
        if self.n_heads % max(1, self.n_kv_heads):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.ssm_state and self.n_ssm_heads % self.ssm_groups:
            raise ValueError("ssm_groups must divide the SSM heads")
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))
        if any(not 0 <= i < self.n_layers for i in self.hybrid_layer_ids):
            raise ValueError("hybrid_layer_ids must lie in [0, n_layers)")
        if self.family == "moe" and (self.n_experts <= 0 or self.experts_per_token <= 0):
            raise ValueError("moe family needs n_experts/experts_per_token")

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embedding/unembedding
        shard cleanly over any TP degree <= 256 (pad ids are never targets)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for roofline math."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        dense_mlp = 3 * d * self.d_ff
        n = emb
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + dense_mlp + 2 * d)
        elif self.family == "moe":
            moe_mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            n += self.n_layers * (attn + moe_mlp + 2 * d)
        elif self.family == "hybrid":
            di, N, H = self.d_inner_ssm, self.ssm_state, self.n_ssm_heads
            # in_proj -> [z, x, B, C, dt]; conv over (x,B,C); out_proj
            conv_dim = di + 2 * N * 0 + 2 * self.ssm_state * H // H  # see mamba2.py
            mamba = d * (2 * di + 2 * self.ssm_state + H) + di * d + 4 * di
            n += self.n_layers * (mamba + 2 * d)
            n_shared = (attn + dense_mlp + 2 * d) if self.shared_attn_every else 0
            n += n_shared  # weight-tied: counted once
        elif self.family == "ssm":  # xlstm
            di = self.ssm_expand * d
            mlstm = d * (3 * di + di) + di * d + 3 * di
            n += self.n_layers * (mlstm + 2 * d)
        elif self.family == "audio":
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            dec = self.n_layers * (2 * attn + dense_mlp + 3 * d)
            n += enc + dec
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        active_mlp = self.experts_per_token * 3 * d * self.d_ff + d * self.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + active_mlp + 2 * d)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# Archs with sub-quadratic attention state that run long_500k (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"zamba2-7b", "xlstm-1.3b", "gemma3-12b"}


def shapes_for(arch_id: str) -> tuple[ShapeSpec, ...]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_id in LONG_CONTEXT_ARCHS:
        out.append(LONG_500K)
    return tuple(out)


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg``'s first ``n_layers`` layers, with the hybrid sites among them."""
    return dataclasses.replace(cfg, n_layers=n_layers, hybrid_layer_ids=tuple(
        i for i in cfg.hybrid_layer_ids if i < n_layers))


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the SMOKE config: same family/topology, tiny sizes."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=cfg.d_ff and 256,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.family == "moe":
        base.update(n_experts=8, experts_per_token=2, d_ff=64)
    if cfg.family in ("hybrid", "ssm"):
        base.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.shared_attn_every:
        base.update(n_layers=4, shared_attn_every=2)
    if cfg.slstm_period:
        base.update(n_layers=4, slstm_period=2)
    if cfg.encoder_layers:
        base.update(encoder_layers=2, n_layers=2, encoder_seq=64)
    if cfg.n_patches:
        base.update(n_patches=16)
    if cfg.local_global_ratio:
        base.update(n_layers=6, local_global_ratio=2, sliding_window=32)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
