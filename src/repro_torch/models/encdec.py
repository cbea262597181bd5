"""Whisper-style encoder-decoder, family ``"audio"``. The conv/mel frontend
is a stub: ``batch["frames"]`` holds precomputed frame embeddings
(B, encoder_seq, d).

The port of ``src/repro/models/encdec.py``: ``encode``, ``loss_fn``
(training), ``prefill``, ``decode_step``, ``init_cache``. As in ``repro``:
sinusoidal absolute embeddings on the encoder, whose self-attention is
non-causal without RoPE; RoPE self-attention in the decoder, then
cross-attention to the encoder's output, then SwiGLU; an untied unembed.
Params keep ``repro``'s key paths (``enc_layers``/``dec_layers`` stacked on a
leading layer dim). Every norm goes through ``layers.norm`` (the rmsnorm
kernel on the card); the encoder's and the cross-attention's flash
attention runs non-causal, the cross-attention's with S queries against
the T encoder keys. Training wraps each encoder and decoder layer in
``remat_wrap``, as ``repro`` does.

The cache holds ``repro``'s keys: the decoder's self-attention ``k``/``v``
(L, B, S_max, K, hd), the cross-attention's ``ck``/``cv`` (L, B, T, K, hd),
computed once from the encoder's output at prefill, and ``pos``, a 0-dim
int32 on the device. Decode writes k/v in place.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels.sharded import cache_write_prefix
from ..spans import span
from .attention import KVCache, attention, attn_init, split_heads
from .common import Model, remat_wrap, serving, stack_init, unstack
from .layers import (
    cross_entropy_loss,
    dense,
    dtype_of,
    embed,
    embed_init,
    norm,
    rmsnorm_init,
    sinusoid_embed,
    swiglu,
    swiglu_init,
    unembed,
)


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    return {
        "attn": attn_init(gen, cfg, dtype=dtype),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
        "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
        "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    return {
        "self_attn": attn_init(gen, cfg, dtype=dtype),
        "cross_attn": attn_init(gen, cfg, dtype=dtype),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
        "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
        "lnc": rmsnorm_init(cfg.d_model, dtype, dev),
        "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
    }


def init(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device (random numbers differ from
    ``jax.random``'s; parity tests carry ``repro``'s weights in instead)."""
    dtype = dtype_of(cfg)
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "unembed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_layers": stack_init(gen, cfg.encoder_layers,
                                 functools.partial(_enc_layer_init, cfg=cfg, dtype=dtype)),
        "dec_layers": stack_init(gen, cfg.n_layers,
                                 functools.partial(_dec_layer_init, cfg=cfg, dtype=dtype)),
        "enc_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }


def _enc_layer(lp, x, cfg: ModelConfig, positions):
    h, _ = attention(lp["attn"], norm(lp["ln1"], x, cfg.norm_eps), cfg,
                     positions=positions, theta=0.0, causal=False)
    x = x + h
    return x + swiglu(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps))


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *, remat=None) -> torch.Tensor:
    """frames: (B, T, d) precomputed frame embeddings (the frontend stub)."""
    T = frames.shape[1]
    x = frames + sinusoid_embed(T, cfg.d_model, frames.device).to(frames.dtype)
    positions = torch.arange(T, device=frames.device)
    layer = remat_wrap(functools.partial(_enc_layer, cfg=cfg, positions=positions), remat)
    for lp in unstack(params["enc_layers"], cfg.encoder_layers):
        x = layer(lp, x)
    return norm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(lp, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's k/v of one decoder layer, (B, T, K, hd) each."""
    K, hd = cfg.n_kv_heads, cfg.hd
    return (split_heads(dense(lp["cross_attn"]["wk"], enc_out), K, hd),
            split_heads(dense(lp["cross_attn"]["wv"], enc_out), K, hd))


def _dec_layer(lp, x, cfg: ModelConfig, *, positions, enc_kv, cache=None, cache_pos=None):
    h, kv = attention(lp["self_attn"], norm(lp["ln1"], x, cfg.norm_eps), cfg,
                      positions=positions, theta=cfg.rope_theta, cache=cache,
                      cache_pos=cache_pos)
    x = x + h
    h, _ = attention(lp["cross_attn"], norm(lp["lnc"], x, cfg.norm_eps), cfg,
                     positions=positions, theta=0.0, kv_override=enc_kv)
    x = x + h
    return x + swiglu(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps)), kv


def _dec_residual(lp, x, enc_out, cfg: ModelConfig, positions):
    """A decoder layer for training: its output only, its cross k/v made
    from ``enc_out`` inside (so that remat recomputes them)."""
    return _dec_layer(lp, x, cfg, positions=positions, enc_kv=_cross_kv(lp, enc_out, cfg))[0]


def loss_fn(params, batch, cfg: ModelConfig, *, remat=None):
    """Mean next-token cross entropy of the decoder over ``batch["tokens"]``
    against ``batch["labels"]`` (-100 ignored), given ``batch["frames"]``.
    Returns (loss, {"ce", "aux"}), aux 0."""
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    x = embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    layer = remat_wrap(functools.partial(_dec_residual, cfg=cfg, positions=positions), remat)
    for lp in unstack(params["dec_layers"], cfg.n_layers):
        x = layer(lp, x, enc_out)
    h = norm(params["final_norm"], x, cfg.norm_eps)
    with span("model.head"):
        ce = cross_entropy_loss(unembed(params["unembed"], h), batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


@serving
def prefill(params, batch, S_max: int, cfg: ModelConfig, *, cache=None):
    """Encode ``batch["frames"]``, run the prompt, return (last-position
    logits, decode cache). ``cache``, where given, is a zero cache of
    ``init_cache``'s form to fill: the sharded prefill passes one laid out
    on its mesh (the cross k/v copied into its layout, the self k/v written
    by the rank holding each row)."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prompt length {S} > S_max {S_max}")
    positions = torch.arange(S, device=x.device)
    if cache is None:
        cache = init_cache(cfg, B, S_max, x.device, enc_len=enc_out.shape[1])
    elif cache["ck"].shape[2] != enc_out.shape[1]:
        raise ValueError(f"cache holds {cache['ck'].shape[2]} encoder rows, the frames "
                         f"{enc_out.shape[1]}")
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        ck, cv = _cross_kv(lp, enc_out, cfg)
        cache["ck"][i].copy_(ck)
        cache["cv"][i].copy_(cv)
        x, kv = _dec_layer(lp, x, cfg, positions=positions, enc_kv=(ck, cv))
        for dst, src in ((cache["k"][i], kv.k), (cache["v"][i], kv.v)):
            if isinstance(dst, DTensor):
                cache_write_prefix(dst, src)
            else:
                dst[:, :S] = src
    h = norm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(S)
    return unembed(params["unembed"], h[:, -1]), cache


@serving
def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"token": (B,)}. Writes the
    self-attention k/v into the cache IN PLACE; returns (logits, cache with
    pos + 1)."""
    x = embed(params["embed"], batch["token"][:, None])
    pos = cache["pos"]
    positions = pos.reshape(1)
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        x, _ = _dec_layer(lp, x, cfg, positions=positions,
                          enc_kv=(cache["ck"][i], cache["cv"][i]),
                          cache=KVCache(cache["k"][i], cache["v"][i]), cache_pos=pos)
    h = norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["unembed"], h[:, 0]), {**cache, "pos": pos + 1}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None, *, enc_len=None):
    dtype = dtype_of(cfg)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    T = cfg.encoder_seq if enc_len is None else enc_len
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    return {
        "k": zeros((L, B, S_max, K, hd)), "v": zeros((L, B, S_max, K, hd)),
        "ck": zeros((L, B, T, K, hd)), "cv": zeros((L, B, T, K, hd)),
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
