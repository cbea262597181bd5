"""Decoder-only transformer LM, family ``"dense"``: init, prefill, decode.

The port of ``src/repro/models/transformer.py`` for the serving path. Params
keep the JAX key paths and stacked leading layer dim (``layers/attn/wq/w`` is
(L, d, H*hd)); the ``lax.scan`` over layers is a loop over that dim.
MoE, the gemma3 local/global pattern, the VLM prefix and the training loss
are later slices.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs.base import ModelConfig
from .attention import KVCache, attention, attn_init
from .common import Model, stack_init, tree_map
from .layers import (
    dtype_of,
    embed,
    embed_init,
    norm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)


# ---------------------------------------------------------------------------
# layer init / apply
# ---------------------------------------------------------------------------
def _layer_init(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    return {
        "attn": attn_init(gen, cfg, dtype=dtype),
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
    }


def _layer_apply(lp, x, cfg: ModelConfig, *, positions, theta: float,
                 window: Optional[int], cache: Optional[KVCache] = None, cache_pos=None):
    """Pre-norm block. Returns (x, kv)."""
    h, kv = attention(
        lp["attn"], norm(lp["ln1"], x, cfg.norm_eps), cfg,
        positions=positions, theta=theta, window=window,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    y = norm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], y), kv


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device (random numbers differ from
    ``jax.random``'s; parity tests carry ``repro``'s weights in instead)."""
    dtype = dtype_of(cfg)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    params["layers"] = stack_init(
        gen, cfg.n_layers, functools.partial(_layer_init, cfg=cfg, dtype=dtype))
    return params


def _logits(params, h):
    return unembed(params.get("unembed", params["embed"]), h)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
@torch.inference_mode()
def prefill(params, batch, S_max: int, cfg: ModelConfig):
    """Run the prompt, return (last-position logits, decode cache).

    The cache is {"k", "v": (L, B, S_max, K, hd), "pos": 0-dim int32}, each
    layer's k/v written into it as the layer runs.
    """
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prompt length {S} > S_max {S_max}")
    device = x.device
    positions = torch.arange(S, device=device)
    cache = init_cache(cfg, B, S_max, device)
    for i in range(cfg.n_layers):
        x, kv = _layer_apply(_layer(params, i), x, cfg, positions=positions,
                             theta=cfg.rope_theta, window=cfg.sliding_window)
        cache["k"][i, :, :S] = kv.k
        cache["v"][i, :, :S] = kv.v
    h = norm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, h[:, -1])
    cache["pos"].fill_(S)
    return logits, cache


@torch.inference_mode()
def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"token": (B,)}.

    Updates ``cache``'s k/v IN PLACE at ``cache["pos"]`` (JAX donates the old
    cache and returns a new one) and returns (logits, cache with pos + 1).
    """
    tok = batch["token"]
    x = embed(params["embed"], tok[:, None])
    pos = cache["pos"]
    positions = pos.reshape(1)
    for i in range(cfg.n_layers):
        x, _ = _layer_apply(
            _layer(params, i), x, cfg, positions=positions, theta=cfg.rope_theta,
            window=cfg.sliding_window, cache=KVCache(cache["k"][i], cache["v"][i]),
            cache_pos=pos,
        )
    h = norm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, h[:, 0])
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    dtype = dtype_of(cfg)
    shape = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
