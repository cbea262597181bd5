"""Zamba2-style hybrid, family ``"hybrid"``: a Mamba2 backbone with one
weight-shared attention+MLP block applied after every ``shared_attn_every``
mamba layers, each invocation site with its own KV cache.

The port of ``src/repro/models/hybrid.py``: ``init``, ``loss_fn``
(training), ``prefill``, ``decode_step``, ``init_cache``. Params keep
``repro``'s key paths: ``mamba_groups`` leaves have leading dims (ng, gs),
``mamba_tail`` leaves (tail,); the ``lax.scan``s are loops over those dims.
Every norm goes through ``layers.norm`` (the rmsnorm kernel on the card).
Training wraps each mamba layer in ``remat_wrap`` and leaves the shared
block unwrapped, as ``repro``'s ``_forward`` does; on the card autograd runs
the rmsnorm, flash attention (hd 112) and SSD intra-chunk backward kernels.
Decode updates the cache in place.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels.sharded import cache_write_prefix
from .attention import KVCache, attention, attn_init
from .common import Model, remat_wrap, serving, stack_init, tree_map
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
from .mamba2 import MambaCache, empty_mamba_cache, mamba_forward, mamba_init


def _groups(cfg: ModelConfig) -> tuple[int, int, int]:
    gs = cfg.shared_attn_every
    ng = cfg.n_layers // gs
    tail = cfg.n_layers - ng * gs
    return ng, gs, tail


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {
        "norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mamba": mamba_init(gen, cfg, dtype=dtype),
    }


def _mamba_layer(lp, x, cfg: ModelConfig, cache: MambaCache | None = None):
    h, state = mamba_forward(lp["mamba"], norm(lp["norm"], x, cfg.norm_eps), cfg,
                             cache=cache)
    return x + h, state


def _mamba_residual(lp, x, cfg: ModelConfig):
    """A mamba layer for training: its output only (the state is dropped)."""
    return _mamba_layer(lp, x, cfg)[0]


def _shared_apply(sp, x, cfg: ModelConfig, *, positions, cache=None, cache_pos=None):
    h, kv = attention(
        sp["attn"], norm(sp["ln1"], x, cfg.norm_eps), cfg,
        positions=positions, theta=cfg.rope_theta,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    x = x + swiglu(sp["mlp"], norm(sp["ln2"], x, cfg.norm_eps))
    return x, kv


def init(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device (random numbers differ from
    ``jax.random``'s; parity tests carry ``repro``'s weights in instead)."""
    dtype = dtype_of(cfg)
    ng, gs, tail = _groups(cfg)
    dev = gen.device
    layer_fn = functools.partial(_mamba_layer_init, cfg=cfg, dtype=dtype)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "mamba_groups": tree_map(lambda a: a.reshape(ng, gs, *a.shape[1:]),
                                 stack_init(gen, ng * gs, layer_fn)),
        "shared": {
            "attn": attn_init(gen, cfg, dtype=dtype),
            "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
            "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
            "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
        },
    }
    if tail:
        params["mamba_tail"] = stack_init(gen, tail, layer_fn)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    return params


def _mamba_slots(params, cfg: ModelConfig, cache):
    """Per mamba layer, in the order the model runs: its params, its
    MambaCache (views into ``cache``) and the shared-block site that runs
    right after it (its group index), or None."""
    ng, gs, tail = _groups(cfg)
    for g in range(ng):
        for i in range(gs):
            yield (tree_map(lambda a: a[g, i], params["mamba_groups"]),
                   MambaCache(cache["g_conv"][g, i], cache["g_h"][g, i]),
                   g if i == gs - 1 else None)
    for i in range(tail):
        yield (tree_map(lambda a: a[i], params["mamba_tail"]),
               MambaCache(cache["t_conv"][i], cache["t_h"][i]), None)


@serving
def prefill(params, batch, S_max: int, cfg: ModelConfig, *, cache=None):
    """Run the prompt, return (last-position logits, decode cache).

    The cache holds ``repro``'s keys: per mamba layer the raw conv tail and
    final SSM state (``g_conv``/``g_h`` (ng, gs, ...), ``t_conv``/``t_h``
    (tail, ...)), per shared-block site its k/v (``sk``/``sv``
    (ng, B, S_max, K, hd)), and ``pos`` (0-dim int32 on the device).
    ``cache``, where given, is a zero cache of that form to fill: the
    sharded prefill passes one laid out on its mesh (the states copied into
    their layout, the k/v written by the rank holding each row).
    """
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prompt length {S} > S_max {S_max}")
    positions = torch.arange(S, device=x.device)
    if cache is None:
        cache = init_cache(cfg, B, S_max, x.device)
    for lp, slot, site in _mamba_slots(params, cfg, cache):
        x, state = _mamba_layer(lp, x, cfg)
        slot.conv.copy_(state.conv)
        slot.h.copy_(state.h)
        if site is not None:
            x, kv = _shared_apply(params["shared"], x, cfg, positions=positions)
            for dst, src in ((cache["sk"][site], kv.k), (cache["sv"][site], kv.v)):
                if isinstance(dst, DTensor):
                    cache_write_prefix(dst, src)
                else:
                    dst[:, :S] = src
    h = norm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(S)
    return logits(params, h[:, -1]), cache


@serving
def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"token": (B,)}.

    Updates ``cache``'s conv windows, SSM states and shared-block k/v IN
    PLACE (JAX returns a new cache) and returns (logits, cache with pos + 1).
    """
    x = embed(params["embed"], batch["token"][:, None])
    pos = cache["pos"]
    positions = pos.reshape(1)
    for lp, slot, site in _mamba_slots(params, cfg, cache):
        x, _ = _mamba_layer(lp, x, cfg, cache=slot)
        if site is not None:
            x, _ = _shared_apply(params["shared"], x, cfg, positions=positions,
                                 cache=KVCache(cache["sk"][site], cache["sv"][site]),
                                 cache_pos=pos)
    h = norm(params["final_norm"], x, cfg.norm_eps)
    return logits(params, h[:, 0]), {**cache, "pos": pos + 1}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    dtype = dtype_of(cfg)
    ng, gs, tail = _groups(cfg)
    mc = empty_mamba_cache(cfg, B, dtype, device)

    def rep(a, *lead):
        return a.expand(*lead, *a.shape).contiguous()

    K, hd = cfg.n_kv_heads, cfg.hd
    cache = {
        "g_conv": rep(mc.conv, ng, gs), "g_h": rep(mc.h, ng, gs),
        "sk": torch.zeros((ng, B, S_max, K, hd), dtype=dtype, device=device),
        "sv": torch.zeros((ng, B, S_max, K, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tail:
        cache["t_conv"] = rep(mc.conv, tail)
        cache["t_h"] = rep(mc.h, tail)
    return cache


def _forward(params, cfg: ModelConfig, x, positions, *, remat=None):
    """``repro``'s ``_forward`` for training: each group's mamba layers (each
    under ``remat_wrap``), then the shared block; then the tail's layers."""
    layer = remat_wrap(functools.partial(_mamba_residual, cfg=cfg), remat)
    ng, gs, tail = _groups(cfg)
    for g in range(ng):
        for i in range(gs):
            x = layer(tree_map(lambda a: a[g, i], params["mamba_groups"]), x)
        x, _ = _shared_apply(params["shared"], x, cfg, positions=positions)
    for i in range(tail):
        x = layer(tree_map(lambda a: a[i], params["mamba_tail"]), x)
    return x


def loss_fn(params, batch, cfg: ModelConfig, *, remat=None):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-100 ignored). Returns (loss, {"ce", "aux"}), aux 0."""
    x = embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    h = _forward(params, cfg, x, positions, remat=remat)
    h = norm(params["final_norm"], h, cfg.norm_eps)
    ce = head_loss(params, h, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
