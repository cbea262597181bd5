"""Decoder-only transformer LM, families ``"dense"`` and ``"moe"``: init,
loss, prefill, decode.

The port of ``src/repro/models/transformer.py``. Params keep the JAX key
paths and stacked leading layer dim (``layers/attn/wq/w`` is (L, d, H*hd));
the ``lax.scan`` over layers is a loop over that dim, through views from one
``unbind`` (whose backward stacks the per-layer grads once). A ``"moe"``
layer takes ``models/moe.py``'s FFN in place of SwiGLU, and the loss adds
``MOE_AUX_COEF`` times the load-balance aux summed over layers. ``loss_fn``
runs under autograd: on the card the norms and attention launch the forward
and backward kernels (``kernels.ops``). The gemma3 local/global pattern and
the VLM prefix are a later slice.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs.base import ModelConfig
from .attention import KVCache, attention, attn_init
from .common import Model, remat_wrap, stack_init
from .layers import (
    cross_entropy_loss,
    dtype_of,
    embed,
    embed_init,
    norm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)
from .moe import moe_ffn, moe_init

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# layer init / apply
# ---------------------------------------------------------------------------
def _layer_init(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    p = {
        "attn": attn_init(gen, cfg, dtype=dtype),
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg, dtype=dtype)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype)
    return p


def _layer_apply(lp, x, cfg: ModelConfig, *, positions, theta: float,
                 window: Optional[int], cache: Optional[KVCache] = None, cache_pos=None):
    """Pre-norm block. Returns (x, kv, aux): aux is the MoE load-balance
    loss, 0.0 for a dense layer."""
    h, kv = attention(
        lp["attn"], norm(lp["ln1"], x, cfg.norm_eps), cfg,
        positions=positions, theta=theta, window=window,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    y = norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_ffn(lp["moe"], y, cfg)
    else:
        m, aux = swiglu(lp["mlp"], y), 0.0
    return x + m, kv, aux


def _unstack(tree, n: int) -> list:
    """Stacked params (leading dim ``n``) -> ``n`` per-layer trees of views."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


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
# forward core (train / prefill share this)
# ---------------------------------------------------------------------------
def _forward(params, cfg: ModelConfig, x, positions, *, want_cache: bool,
             remat: Optional[str] = None):
    """x: (B, S, d) embedded input. Returns (hidden, per-layer KVCache list
    or None, aux summed over layers)."""
    def layer_fn(lp, x):
        return _layer_apply(lp, x, cfg, positions=positions, theta=cfg.rope_theta,
                            window=cfg.sliding_window)

    layer_fn = remat_wrap(layer_fn, remat)
    kvs, aux = [], 0.0
    for lp in _unstack(params["layers"], cfg.n_layers):
        x, kv, a = layer_fn(lp, x)
        aux = aux + a
        if want_cache:
            kvs.append(kv)
    return x, (kvs if want_cache else None), aux


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def loss_fn(params, batch, cfg: ModelConfig, *, remat: Optional[str] = None):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-100 ignored), plus ``MOE_AUX_COEF`` times the MoE
    aux (0 for dense). Returns (loss, {"ce", "aux"})."""
    x = embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, aux = _forward(params, cfg, x, positions, want_cache=False, remat=remat)
    h = norm(params["final_norm"], h, cfg.norm_eps)
    ce = cross_entropy_loss(_logits(params, h), batch["labels"])
    if not torch.is_tensor(aux):                 # no MoE layer
        aux = torch.zeros((), device=ce.device)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}


@torch.inference_mode()
def prefill(params, batch, S_max: int, cfg: ModelConfig):
    """Run the prompt, return (last-position logits, decode cache).

    The cache is {"k", "v": (L, B, S_max, K, hd), "pos": 0-dim int32}.
    """
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prompt length {S} > S_max {S_max}")
    device = x.device
    x, kvs, _ = _forward(params, cfg, x, torch.arange(S, device=device), want_cache=True)
    cache = init_cache(cfg, B, S_max, device)
    for i, kv in enumerate(kvs):
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
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        x, _, _ = _layer_apply(
            lp, x, cfg, positions=positions, theta=cfg.rope_theta,
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
        loss=functools.partial(loss_fn, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
