"""GQA attention with causal/sliding-window masks and a decode KV cache.

The port of ``src/repro/models/attention.py``. Prefill runs
``kernels.ops.flash_attention`` and decode ``kernels.ops.decode_attention``:
the CUDA kernels on the card, their plain versions on the CPU. ``sdpa`` is
the plain reference the tests hold the kernels' plain versions to. On the
CPU a prefill of ``BLOCKWISE_THRESHOLD`` or more positions runs
``blockwise_sdpa``, as ``repro`` does without kernels, so that no (S, T)
score matrix is built there (a sharded step's on each rank's local shards,
through the flash kernel's layout rules); the card keeps the flash kernel.

The ring cache of gemma3's local layers keeps position p at slot p % W
from the start (``transformer.prefill`` fills it so), so after the write of
position ``pos`` its filled slots are exactly the keys in (pos - W, pos]:
the decode kernel reads them as a cache of ``min(pos + 1, W)`` rows.
``repro`` reaches the same key set by masking with the slots' positions.

Cross-attention (``kv_override``, Whisper's decoder) takes q from x and
the given encoder k/v, without RoPE, qk-norm on k or a cache, non-causal:
``ops.flash_attention(causal=False)`` over S queries and T keys, and at one
query row without autograd (decode) ``ops.decode_attention`` over all T
keys (``kv_len`` = T, a device int32 made on the device).

Under a mesh hint (``runtime/parallel.py``'s sharded steps) q/k/v are
DTensors, constrained to the head-aligned layout ``repro`` asks for (batch
over dp, heads over "model" where that divides), and the kernels run on
local shards (``kernels/sharded.py``); a sequence-sharded decode cache is
written only by the rank holding the row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..hints import constrain, get_mesh_hint, hint_spec
from ..kernels import ops, sharded
from ..precision import compute_dtype
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
         window: Optional[int] = None, q_offset=0, kv_len=None,
         softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Reference GQA attention. q: (B,S,H,hd); k/v: (B,T,K,hd); H % K == 0;
    scores q . k times ``softmax_scale`` (default hd^-1/2)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scale = hd ** -0.5 if softmax_scale is None else softmax_scale
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    logits = logits + _mask(S, T, causal=causal, window=window, q_offset=q_offset,
                            kv_len=kv_len, device=q.device)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


# repro's threshold (``src/repro/models/attention.py``): at this many
# positions the CPU prefill runs blockwise
BLOCKWISE_THRESHOLD = 2048


def blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None, q_offset=0, q_chunk: int = 512,
                   k_chunk: int = 1024, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, k_chunk) blocks, in plain
    PyTorch: O(S * hd) memory instead of O(S * T). Falls back to ``sdpa``
    where the chunks do not divide S and T, as ``repro``'s does."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qc, kc = min(q_chunk, S), min(k_chunk, T)
    if S % qc or T % kc:
        return sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    softmax_scale=softmax_scale)
    scale = hd ** -0.5 if softmax_scale is None else softmax_scale
    dev = q.device
    outs = []
    for qi in range(S // qc):
        qg = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, K, G, hd)
        rows = q_offset + qi * qc + torch.arange(qc, device=dev)[:, None]
        m = torch.full((B, K, G, qc), float("-inf"), device=dev)
        l = torch.zeros((B, K, G, qc), device=dev)
        acc = torch.zeros((B, K, G, qc, hd), device=dev)
        for ki in range(T // kc):
            kcur, vcur = k[:, ki * kc:(ki + 1) * kc], v[:, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bskgd,btkd->bkgst", qg, kcur).float() * scale
            cols = ki * kc + torch.arange(kc, device=dev)[None, :]
            ok = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (cols <= rows)
            if window is not None:
                ok = ok & (cols > rows - window)
            s = torch.where(ok, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum("bkgst,btkd->bkgsd", p, vcur.float())
            m = m_new
        out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def split_heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd) in ``repro``'s head-aligned layout:
    heads over "model" where it divides n, else replicated (never a split
    head dim). Under a mesh hint a DTensor's flat dim is first made whole
    where its shards would split heads (the collective ``repro``'s
    constraint places); without one, a plain reshape."""
    B, S = y.shape[0], y.shape[1]
    mesh = get_mesh_hint()
    if isinstance(y, DTensor) and mesh is not None \
            and hint_spec(mesh, (B, S, n, hd), ("dp", None, "model", None))[2] is None:
        y = constrain(y, "dp", None, None)
    return constrain(y.reshape(B, S, n, hd), "dp", None, "model", None)


def _flat(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H*hd), laid out for the row-sharded output
    projection (flat dim over "model"). Where "model" does not divide H the
    heads are whole on every rank, and the projection's gradient, sharded
    over the flat dim, could not be viewed back as heads: made whole at
    this step of the backward instead (a slice forward, a gather back)."""
    B, S, H, hd = out.shape
    return constrain(out.reshape(B, S, H * hd), "dp", None, "model")


def softmax_scale(cfg: ModelConfig) -> Optional[float]:
    """The scores' scale: None (the kernels' hd^-1/2) unless the config
    divides the head dim first, as Zamba2's (hd/2)^-1/2 (``repro``'s configs,
    which the parity tests pass in, have no such field)."""
    div = getattr(cfg, "attn_scale_div", 1)
    return None if div == 1 else (cfg.hd / div) ** -0.5


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
      * train/prefill: ``cache is None`` -> attends within x (flash kernel;
        ``blockwise_sdpa`` on the CPU from ``BLOCKWISE_THRESHOLD`` positions);
        returns (out, KVCache(k, v)) so prefill can keep the cache.
      * decode: ``cache`` given, x is (B, 1, d); k/v are written into the
        cache at ``cache_pos`` (a 0-dim int tensor) IN PLACE, where the JAX
        version returns a new cache, and the decode kernel attends over
        ``[0, cache_pos + 1)``. The returned KVCache holds the same tensors.
      * ring decode (gemma3's local layers): ``kv_positions`` (the ring's
        slot positions) given; k/v are written at ``cache_write_pos``
        (``cache_pos % W``, a 0-dim tensor) and the decode kernel reads the
        W-slot ring as a cache of ``min(cache_pos + 1, W)`` rows, without a
        window: with position p at slot p % W those rows are the keys in
        (cache_pos - W, cache_pos], the set ``repro`` picks from
        ``kv_positions``. Nothing is read back to the host.
      * cross-attention: ``kv_override=(k, v)`` (B, T, K, hd) skips rope,
        the cache and the causal mask; returns (out, None).
    """
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(dense(p["wq"], x), H, hd)
    if kv_override is not None:
        if cfg.qk_norm:
            q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k, v = kv_override
        if S == 1 and not torch.is_grad_enabled():
            kv_len = torch.full((), k.shape[1], dtype=torch.int32, device=k.device)
            out = ops.decode_attention(q, k, v, kv_len=kv_len)
        else:
            out = ops.flash_attention(q, k, v, causal=False)
        return dense(p["wo"], _flat(out)), None

    k = split_heads(dense(p["wk"], x), K, hd)
    v = split_heads(dense(p["wv"], x), K, hd)

    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if theta > 0:
        cos, sin = rope_tables(positions, hd, theta, dtype=compute_dtype(q.dtype))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        scale = softmax_scale(cfg)
        if q.device.type == "cpu" and S >= BLOCKWISE_THRESHOLD and isinstance(q, DTensor):
            out = sharded.flash_attention(q, k, v, causal=causal, window=window,
                                          local=functools.partial(blockwise_sdpa,
                                                                  softmax_scale=scale))
        elif q.device.type == "cpu" and S >= BLOCKWISE_THRESHOLD:
            out = blockwise_sdpa(q, k, v, causal=causal, window=window, softmax_scale=scale)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      softmax_scale=scale)
        new_cache = KVCache(k, v)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got S={S}")
        if softmax_scale(cfg) is not None:
            raise ValueError("the decode kernel takes the default softmax scale only")
        ring = kv_positions is not None
        at = cache_write_pos if ring else cache_pos
        if isinstance(cache.k, DTensor):
            sharded.cache_write_at(cache.k, at, k)
            sharded.cache_write_at(cache.v, at, v)
        else:
            idx = at.reshape(1).long()
            cache.k.index_copy_(1, idx, k)
            cache.v.index_copy_(1, idx, v)
        if ring:
            kv_len = torch.clamp(cache_pos + 1, max=cache.k.shape[1]).to(torch.int32)
            window = None
        else:
            kv_len = (cache_pos + 1).to(torch.int32)
        out = ops.decode_attention(q, cache.k, cache.v, kv_len=kv_len, window=window)
        new_cache = cache

    y = dense(p["wo"], _flat(out))
    return y, new_cache

