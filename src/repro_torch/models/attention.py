"""GQA attention with causal/sliding-window masks and a decode KV cache.

The port of ``src/repro/models/attention.py`` for the serving path. Prefill
runs ``kernels.ops.flash_attention`` and decode ``kernels.ops.decode_attention``:
the CUDA kernels on the card, their plain versions on the CPU. ``sdpa`` is
the plain reference the tests hold the kernels' plain versions to.

Not ported yet: the ring cache (``kv_positions``, gemma3) and
``kv_override`` (cross-attention), which raise, and ``blockwise_sdpa``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, dense, dense_init, head_rmsnorm, rope_tables

_NEG = -2.0e38


class KVCache(NamedTuple):
    """Per-layer decode cache. k/v: (B, S_max, K, hd)."""

    k: torch.Tensor
    v: torch.Tensor


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _mask(S_q: int, S_k: int, *, causal: bool, window: Optional[int], q_offset,
          kv_len=None, device=None) -> torch.Tensor:
    """(S_q, S_k) additive float32 mask. ``q_offset``: absolute position of
    query row 0 (int or 0-dim tensor). ``kv_len``: valid prefix of the keys."""
    rows = torch.arange(S_q, device=device)[:, None] + q_offset
    cols = torch.arange(S_k, device=device)[None, :]
    ok = torch.ones((S_q, S_k), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (cols <= rows)
    if window is not None:
        ok = ok & (cols > rows - window)
    if kv_len is not None:
        ok = ok & (cols < kv_len)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
         window: Optional[int] = None, q_offset=0, kv_len=None) -> torch.Tensor:
    """Reference GQA attention. q: (B,S,H,hd); k/v: (B,T,K,hd); H % K == 0."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (hd ** -0.5)
    logits = logits + _mask(S, T, causal=causal, window=window, q_offset=q_offset,
                            kv_len=kv_len, device=q.device)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


def attention(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    theta: float,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[KVCache] = None,
    cache_pos: Optional[torch.Tensor] = None,
    cache_write_pos=None,
    kv_positions=None,
    kv_override: Optional[tuple] = None,
):
    """Full attention sub-layer: qkv proj -> qk-norm -> rope -> attention -> out proj.

    Modes:
      * train/prefill: ``cache is None`` -> attends within x (flash kernel);
        returns (out, KVCache(k, v)) so prefill can keep the cache.
      * decode: ``cache`` given, x is (B, 1, d); k/v are written into the
        cache at ``cache_pos`` (a 0-dim int tensor) IN PLACE, where the JAX
        version returns a new cache, and the decode kernel attends over
        ``[0, cache_pos + 1)``. The returned KVCache holds the same tensors.
    """
    if kv_positions is not None or cache_write_pos is not None:
        raise NotImplementedError("ring KV cache (kv_positions) is not ported yet")
    if kv_override is not None:
        raise NotImplementedError("cross-attention (kv_override) is not ported yet")

    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    k = dense(p["wk"], x).reshape(B, S, K, hd)
    v = dense(p["wv"], x).reshape(B, S, K, hd)

    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if theta > 0:
        cos, sin = rope_tables(positions, hd, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        new_cache = KVCache(k, v)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got S={S}")
        idx = cache_pos.reshape(1).long()
        cache.k.index_copy_(1, idx, k)
        cache.v.index_copy_(1, idx, v)
        kv_len = (cache_pos + 1).to(torch.int32)
        out = ops.decode_attention(q, cache.k, cache.v, kv_len=kv_len, window=window)
        new_cache = cache

    y = dense(p["wo"], out.reshape(B, S, H * hd))
    return y, new_cache

