"""xLSTM LM, family ``"ssm"``: ``nb`` blocks of one sLSTM block and
``nm = slstm_period - 1`` mLSTM layers, a final norm and the tied unembed.

The port of ``src/repro/models/xlstm_model.py``: ``init``, ``loss_fn``
(training), ``prefill``, ``decode_step``, ``init_cache``. Params keep
``repro``'s key paths: ``slstm`` leaves (nb, ...), ``mlstm`` leaves
(nb, nm, ...); the per-layer trees are views from one ``unstack`` (whose
backward stacks the per-layer grads once). Training wraps each mLSTM layer
in ``remat_wrap`` and leaves the sLSTM blocks unwrapped, as ``repro``'s
``_forward`` does; on the card autograd runs the rmsnorm backward kernel.

The cache keeps ``repro``'s keys as stacked tensors: ``"s"`` the sLSTM
states (c, n, m, h), each (nb, B, H, dh) ((nb, B, H) for m); ``"m"`` the
mLSTM states (conv, C, n, m), each (nb, nm, B, ...); ``"pos"`` a 0-dim
int32 on the device. Decode updates them in place and reads nothing back to
the host. ``repro``'s prefill keeps a conv tail shorter than W-1 rows after
a prompt shorter than that; the port pads it with the zeros the causal conv
pads with, so such a prompt decodes as its full forward does.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..spans import span
from .common import Model, remat_wrap, serving, stack_init, tree_map, unstack
from .layers import cross_entropy_loss, dtype_of, embed, embed_init, norm, rmsnorm_init, unembed
from .xlstm import (
    MLSTMCache,
    SLSTMCache,
    empty_mlstm_cache,
    empty_slstm_state,
    mlstm_forward,
    mlstm_init,
    slstm_forward,
    slstm_init,
)


def _blocks(cfg: ModelConfig) -> tuple[int, int]:
    """(n blocks, mLSTM layers a block)."""
    p = cfg.slstm_period
    return cfg.n_layers // p, p - 1


def _m_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {
        "norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mlstm": mlstm_init(gen, cfg, dtype=dtype),
    }


def _m_layer(lp, x, cfg: ModelConfig, cache: MLSTMCache | None = None):
    h, state = mlstm_forward(lp["mlstm"], norm(lp["norm"], x, cfg.norm_eps), cfg, cache=cache)
    return x + h, state


def _m_residual(lp, x, cfg: ModelConfig):
    """An mLSTM layer for training: its output only (the state is dropped)."""
    return _m_layer(lp, x, cfg)[0]


def init(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device (random numbers differ from
    ``jax.random``'s; parity tests carry ``repro``'s weights in instead)."""
    dtype = dtype_of(cfg)
    nb, nm = _blocks(cfg)
    m_all = stack_init(gen, nb * nm, functools.partial(_m_layer_init, cfg=cfg, dtype=dtype))
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "slstm": stack_init(gen, nb, lambda g: slstm_init(g, cfg, dtype=dtype)),
        "mlstm": tree_map(lambda a: a.reshape(nb, nm, *a.shape[1:]), m_all),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    return params


def _logits(params, h):
    return unembed(params.get("unembed", params["embed"]), h)


def _layers(params, cfg: ModelConfig):
    """Per block: its sLSTM params and its nm mLSTM layers' params (views)."""
    nb, nm = _blocks(cfg)
    return zip(unstack(params["slstm"], nb), (unstack(m, nm)
                                               for m in unstack(params["mlstm"], nb)))


def _forward(params, cfg: ModelConfig, x, *, remat=None):
    """``repro``'s ``_forward`` for training: each block's sLSTM (not
    wrapped), then its mLSTM layers, each under ``remat_wrap``."""
    layer = remat_wrap(functools.partial(_m_residual, cfg=cfg), remat)
    for sp, mps in _layers(params, cfg):
        x, _ = slstm_forward(sp, x, cfg)
        for lp in mps:
            x = layer(lp, x)
    return x


def loss_fn(params, batch, cfg: ModelConfig, *, remat=None):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-100 ignored). Returns (loss, {"ce", "aux"}), aux 0."""
    x = embed(params["embed"], batch["tokens"])
    h = norm(params["final_norm"], _forward(params, cfg, x, remat=remat), cfg.norm_eps)
    with span("model.head"):
        ce = cross_entropy_loss(_logits(params, h), batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def _blocks_whole(cache):
    """The cache with any DTensor state whose block dim (dim 0) is sharded
    made whole over it. ``repro``'s cache rule puts "dp" on dim -3, which
    for the sLSTM's m (nb, B, H) is the block dim; a block's state is read
    and written on every rank, so that leaf (nb·B·H values) is gathered
    once, and the cache returned keeps it whole."""
    def whole(t):
        if isinstance(t, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                          for p in t.placements):
            return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Shard)
                                                  and p.dim == 0 else p for p in t.placements])
        return t
    return {**cache, "s": tuple(map(whole, cache["s"])), "m": tuple(map(whole, cache["m"]))}


@serving
def prefill(params, batch, S_max: int, cfg: ModelConfig, *, cache=None):
    """Run the prompt, return (last-position logits, decode cache): each
    layer's state after the prompt, written into a cache from
    ``init_cache`` (or into ``cache``, a zero cache of that form: the
    sharded prefill passes one laid out on its mesh). ``S_max`` is not
    needed by the recurrent state."""
    x = embed(params["embed"], batch["tokens"])
    B, S = batch["tokens"].shape
    cache = _blocks_whole(init_cache(cfg, B, S_max, x.device) if cache is None else cache)
    for b, (sp, mps) in enumerate(_layers(params, cfg)):
        x, s_state = slstm_forward(sp, x, cfg)
        for dst, src in zip(cache["s"], s_state):
            dst[b].copy_(src)
        for i, lp in enumerate(mps):
            x, m_state = _m_layer(lp, x, cfg)
            for dst, src in zip(cache["m"], m_state):
                dst[b, i].copy_(src)
    h = norm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(S)
    return _logits(params, h[:, -1]), cache


@serving
def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"token": (B,)}. Updates the
    cache's states IN PLACE (JAX returns a new cache) and returns (logits,
    cache with pos + 1)."""
    cache = _blocks_whole(cache)
    x = embed(params["embed"], batch["token"][:, None])
    for b, (sp, mps) in enumerate(_layers(params, cfg)):
        x, _ = slstm_forward(sp, x, cfg, cache=SLSTMCache(*(t[b] for t in cache["s"])))
        for i, lp in enumerate(mps):
            x, _ = _m_layer(lp, x, cfg, cache=MLSTMCache(*(t[b, i] for t in cache["m"])))
    h = norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, h[:, 0]), {**cache, "pos": cache["pos"] + 1}


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None):
    nb, nm = _blocks(cfg)
    s0 = empty_slstm_state(cfg, B, device)
    m0 = empty_mlstm_cache(cfg, B, dtype_of(cfg), device)

    def rep(a, *lead):
        return a.expand(*lead, *a.shape).contiguous()

    return {"s": tuple(rep(a, nb) for a in s0), "m": tuple(rep(a, nb, nm) for a in m0),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
