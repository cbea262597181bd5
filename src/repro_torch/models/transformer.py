"""Decoder-only transformer LM, families ``"dense"``, ``"moe"`` and ``"vlm"``,
with gemma3's local/global block pattern: init, loss, prefill, decode.

The port of ``src/repro/models/transformer.py``. Params keep the JAX key
paths and stacked leading layer dim (``layers/attn/wq/w`` is (L, d, H*hd));
the ``lax.scan`` over layers is a loop over that dim, through views from one
``unbind`` (whose backward stacks the per-layer grads once). A ``"moe"``
layer takes ``models/moe.py``'s FFN in place of SwiGLU, and the loss adds
``MOE_AUX_COEF`` times the load-balance aux summed over layers. ``loss_fn``
runs under autograd: on the card the norms and attention launch the forward
and backward kernels (``kernels.ops``).

gemma3 (``local_global_ratio`` R > 0): G = n_layers / (R + 1) blocks of R
local layers (``rope_theta``, window W) and one global layer
(``global_rope_theta``, no window); params ``local_layers`` (G, R, ...) and
``global_layers`` (G, ...). Its cache is ``repro``'s: rings ``lk``/``lv``
(G, R, B, W, K, hd) with ``ring_pos`` (W,) and ``gk``/``gv`` (G, B, S_max,
K, hd), but position p always sits at ring slot p % W. ``repro``'s prefill
puts the trailing W positions at slots 0..W-1 while its decode writes slot
pos % W, which agree only when S <= W or S % W == 0 (ROADMAP Queue 3); the
port's ring equals ``repro``'s rolled by S % W.

VLM (family ``"vlm"``): ``batch["patch_embeds"]`` (B, n_patches, d) is put
before the token embeddings; the loss drops those rows before the unembed,
and the cache counts them.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels.sharded import cache_write_prefix
from .attention import KVCache, attention, attn_init
from .common import Model, remat_wrap, serving, stack_init, tree_map, unstack
from .layers import (
    dtype_of,
    embed,
    embed_init,
    head_loss,
    logits,
    norm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
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
                 window: Optional[int], cache: Optional[KVCache] = None, cache_pos=None,
                 cache_write_pos=None, kv_positions=None):
    """Pre-norm block. Returns (x, kv, aux): aux is the MoE load-balance
    loss, 0.0 for a dense layer."""
    h, kv = attention(
        lp["attn"], norm(lp["ln1"], x, cfg.norm_eps), cfg,
        positions=positions, theta=theta, window=window,
        cache=cache, cache_pos=cache_pos, cache_write_pos=cache_write_pos,
        kv_positions=kv_positions,
    )
    x = x + h
    y = norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_ffn(lp["moe"], y, cfg)
    else:
        m, aux = swiglu(lp["mlp"], y), 0.0
    return x + m, kv, aux


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
    layer_fn = functools.partial(_layer_init, cfg=cfg, dtype=dtype)
    if cfg.local_global_ratio:
        R, G = _blocks(cfg)
        local = stack_init(gen, G * R, layer_fn)
        params["local_layers"] = tree_map(lambda a: a.reshape(G, R, *a.shape[1:]), local)
        params["global_layers"] = stack_init(gen, G, layer_fn)
    else:
        params["layers"] = stack_init(gen, cfg.n_layers, layer_fn)
    return params


def _blocks(cfg: ModelConfig) -> tuple[int, int]:
    """gemma3's (R locals per block, G blocks)."""
    R = cfg.local_global_ratio
    return R, cfg.n_layers // (R + 1)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token embeddings, after the VLM's patch prefix. Returns (x, n_prefix)."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        return torch.cat([pe.to(x.dtype), x], dim=1), pe.shape[1]
    return x, 0


# ---------------------------------------------------------------------------
# forward core (train / prefill share this)
# ---------------------------------------------------------------------------
def _layers(params, cfg: ModelConfig):
    """Every layer in the order it runs: (where, params, rope theta, window).
    ``where`` is ("layer", i), or gemma3's ("local", g, r) and ("global", g):
    R local layers (``rope_theta``, the window) then one global layer
    (``global_rope_theta``, no window) in each of the G blocks."""
    if not cfg.local_global_ratio:
        for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
            yield ("layer", i), lp, cfg.rope_theta, cfg.sliding_window
        return
    R, G = _blocks(cfg)
    g_theta = cfg.global_rope_theta or cfg.rope_theta
    blocks = zip(unstack(params["local_layers"], G), unstack(params["global_layers"], G))
    for g, (lps, gp) in enumerate(blocks):
        for r, lp in enumerate(unstack(lps, R)):
            yield ("local", g, r), lp, cfg.rope_theta, cfg.sliding_window
        yield ("global", g), gp, g_theta, None


def _layer_cache(cache, where) -> KVCache:
    """Views of layer ``where``'s k/v in the decode cache."""
    kind, *idx = where
    k, v = {"layer": ("k", "v"), "local": ("lk", "lv"), "global": ("gk", "gv")}[kind]
    return KVCache(cache[k][tuple(idx)], cache[v][tuple(idx)])


def _forward(params, cfg: ModelConfig, x, positions, *, keep=None,
             remat: Optional[str] = None):
    """x: (B, S, d) embedded input. Returns (hidden, aux summed over
    layers). ``keep(where, kv)``, where given, takes each layer's KVCache as
    the layer finishes (``where`` as ``_layers`` names it)."""
    aux = 0.0
    for where, lp, theta, window in _layers(params, cfg):
        layer_fn = remat_wrap(functools.partial(_layer_apply, cfg=cfg, positions=positions,
                                                theta=theta, window=window), remat)
        x, kv, a = layer_fn(lp, x)
        aux = aux + a
        if keep:
            keep(where, kv)
    return x, aux


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def loss_fn(params, batch, cfg: ModelConfig, *, remat: Optional[str] = None):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-100 ignored), plus ``MOE_AUX_COEF`` times the MoE
    aux (0 for dense). A VLM's patch prefix is dropped before the unembed.
    Returns (loss, {"ce", "aux"})."""
    x, n_prefix = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux = _forward(params, cfg, x, positions, remat=remat)
    h = norm(params["final_norm"], h, cfg.norm_eps)[:, n_prefix:]
    ce = head_loss(params, h, batch["labels"])
    if not torch.is_tensor(aux):                 # no MoE layer
        aux = torch.zeros((), device=ce.device)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}


@serving
def prefill(params, batch, S_max: int, cfg: ModelConfig, *, cache=None):
    """Run the prompt (a VLM's patch prefix included), return (last-position
    logits, decode cache). Each layer's k/v go into the cache as the layer
    finishes.

    The cache is {"k", "v": (L, B, S_max, K, hd), "pos": 0-dim int32}; for
    gemma3 {"lk", "lv", "ring_pos", "gk", "gv", "pos"} (module docstring).
    ``cache``, where given, is a zero cache of that form to fill: the
    sharded prefill passes one laid out on its mesh.
    """
    x, _ = _embed_inputs(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    if S > S_max:
        raise ValueError(f"prompt length {S} > S_max {S_max}")
    device = x.device
    if cache is None:
        cache = init_cache(cfg, B, S_max, device)
    if cfg.local_global_ratio:
        W = cfg.sliding_window
        first = max(0, S - W)                           # the trailing min(S, W) positions
        kept = torch.arange(first, S, device=device)
        cache["ring_pos"].index_copy_(0, kept % W, kept.to(torch.int32))

    def keep(where, kv):
        dst = _layer_cache(cache, where)
        for d, src in ((dst.k, kv.k), (dst.v, kv.v)):
            if where[0] == "local":
                # position p at slot p % W: the kept rows rolled by first % W
                # fill slots 0..min(S, W)-1, a prefix write
                src = torch.roll(src[:, first:], first % W, dims=1)
            if isinstance(d, DTensor):
                cache_write_prefix(d, src)             # the rank holding each row
            else:
                d[:, :src.shape[1]] = src
    x, _ = _forward(params, cfg, x, torch.arange(S, device=device), keep=keep)
    h = norm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(S)
    return logits(params, h[:, -1]), cache


@serving
def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"token": (B,)}.

    Updates ``cache``'s tensors IN PLACE at ``cache["pos"]`` (JAX donates
    the old cache and returns a new one; gemma3's rings and ``ring_pos`` at
    slot pos % W) and returns (logits, cache with pos + 1). Reads nothing
    back to the host.
    """
    tok = batch["token"]
    x = embed(params["embed"], tok[:, None])
    pos = cache["pos"]
    positions = pos.reshape(1)
    ring = {}
    if cfg.local_global_ratio:
        wp = torch.remainder(pos, cfg.sliding_window)
        cache["ring_pos"].index_copy_(0, wp.reshape(1).long(), pos.reshape(1))
        ring = {"cache_write_pos": wp, "kv_positions": cache["ring_pos"]}
    for where, lp, theta, window in _layers(params, cfg):
        x, _, _ = _layer_apply(lp, x, cfg, positions=positions, theta=theta, window=window,
                               cache=_layer_cache(cache, where), cache_pos=pos,
                               **(ring if where[0] == "local" else {}))
    h = norm(params["final_norm"], x, cfg.norm_eps)
    return logits(params, h[:, 0]), {**cache, "pos": pos + 1}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    dtype = dtype_of(cfg)
    K, hd = cfg.n_kv_heads, cfg.hd

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.local_global_ratio:
        R, G = _blocks(cfg)
        W = cfg.sliding_window
        return {"lk": zeros(G, R, B, W, K, hd), "lv": zeros(G, R, B, W, K, hd),
                "ring_pos": torch.full((W,), -1, dtype=torch.int32, device=device),
                "gk": zeros(G, B, S_max, K, hd), "gv": zeros(G, B, S_max, K, hd), "pos": pos}
    return {"k": zeros(cfg.n_layers, B, S_max, K, hd),
            "v": zeros(cfg.n_layers, B, S_max, K, hd), "pos": pos}


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
