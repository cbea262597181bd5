"""Zamba2-7B (arXiv:2411.15242; Hugging Face ``Zamba2ForCausalLM``), family
``"zamba2"``, for training.

A stack of Mamba2 layers (``ssm_groups`` B/C groups, the gated norm per
group). Before each layer in ``hybrid_layer_ids`` a shared transformer block
runs: block k % ``n_shared_blocks`` at site k, so that each block's weights
serve several depths. The block reads the concatenation of the residual
stream and the token embedding (``attn_in`` = 2 d wide) through an rmsnorm;
attention projects it to H heads of ``head_dim`` and back to d, with RoPE on
every dimension and the softmax scale (hd / ``attn_scale_div``)^-1/2; then a
pre-MLP rmsnorm and a gated MLP (exact GELU) whose gate_up product has the
site's own low-rank adapter added. The block has no residual of its own: its
output goes through the site's own ``linear`` (d x d) and is added to the
mamba layer's input before that layer's norm, while the layer's residual is
taken before the addition:

    x <- x + mamba(norm(x + linear_k(block(x, embedding))))

Parameters: ``embed`` (tied to the output projection where the config ties
them), ``final_norm``, ``layers`` (the mamba layers stacked, (n_layers, ...)),
``shared`` (the blocks stacked, (n_shared_blocks, ...)), ``adapters`` and
``linear`` (one a site, (n_sites, ...)). Training wraps each layer, with its
site's block, adapter and ``linear`` where it has one, in ``remat_wrap`` (a
``model.layer`` span); the block runs in a ``zamba2.shared`` span that
counts its ``sites`` and the SSD in ``mamba.ssd``. Serving is not built.
"""

from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from ..spans import span, tally
from .attention import attention
from .common import Model, remat_wrap, stack_init, unstack
from .layers import (
    dense,
    dense_init,
    dtype_of,
    embed,
    embed_init,
    gated_mlp,
    gated_mlp_init,
    head_loss,
    norm,
    rmsnorm_init,
)
from .mamba2 import mamba_forward, mamba_init


def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {"norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "mamba": mamba_init(gen, cfg, dtype=dtype)}


def _block_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, din, H, K, hd = (cfg.d_model, cfg.attn_in or cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd)
    return {"ln1": rmsnorm_init(din, dtype, gen.device),
            "attn": {"wq": dense_init(gen, din, H * hd, dtype=dtype),
                     "wk": dense_init(gen, din, K * hd, dtype=dtype),
                     "wv": dense_init(gen, din, K * hd, dtype=dtype),
                     "wo": dense_init(gen, H * hd, d, dtype=dtype)},
            "ln2": rmsnorm_init(d, dtype, gen.device),
            "mlp": gated_mlp_init(gen, d, cfg.d_ff, dtype=dtype)}


def _adapter_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {"a": dense_init(gen, cfg.d_model, cfg.adapter_rank, dtype=dtype),
            "b": dense_init(gen, cfg.adapter_rank, 2 * cfg.d_ff, dtype=dtype)}


def init(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device."""
    dtype = dtype_of(cfg)
    n_sites = len(cfg.hybrid_layer_ids)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "layers": stack_init(gen, cfg.n_layers,
                             functools.partial(_layer_init, cfg=cfg, dtype=dtype)),
        "shared": stack_init(gen, cfg.n_shared_blocks,
                             functools.partial(_block_init, cfg=cfg, dtype=dtype)),
        "adapters": stack_init(gen, n_sites,
                               functools.partial(_adapter_init, cfg=cfg, dtype=dtype)),
        "linear": stack_init(gen, n_sites, lambda g: dense_init(g, cfg.d_model, cfg.d_model,
                                                                dtype=dtype)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    return params


def shared_site(sp, ap, lp, x, emb, cfg: ModelConfig, positions):
    """One site's shared block (params ``sp``) with its adapter ``ap`` and
    its ``linear`` ``lp``: what is added to the mamba layer's input."""
    with span("zamba2.shared"):
        tally(sites=1)
        h = norm(sp["ln1"], torch.cat([x, emb], dim=-1), cfg.norm_eps)
        h, _ = attention(sp["attn"], h, cfg, positions=positions, theta=cfg.rope_theta)
        h = gated_mlp(sp["mlp"], norm(sp["ln2"], h, cfg.norm_eps), adapter=ap)
        return dense(lp, h)


def _mamba_layer(lp, x, cfg: ModelConfig, add=None):
    h = x if add is None else x + add
    out, _ = mamba_forward(lp["mamba"], norm(lp["norm"], h, cfg.norm_eps), cfg)
    return x + out


def _hybrid_layer(lp, sp, ap, linp, x, emb, positions, cfg: ModelConfig):
    return _mamba_layer(lp, x, cfg, shared_site(sp, ap, linp, x, emb, cfg, positions))


def _forward(params, cfg: ModelConfig, emb, *, remat=None):
    positions = torch.arange(emb.shape[1], device=emb.device)
    layer = remat_wrap(functools.partial(_mamba_layer, cfg=cfg), remat)
    hybrid = remat_wrap(functools.partial(_hybrid_layer, cfg=cfg), remat)
    layers = unstack(params["layers"], cfg.n_layers)
    blocks = unstack(params["shared"], cfg.n_shared_blocks)
    n_sites = len(cfg.hybrid_layer_ids)
    adapters = unstack(params["adapters"], n_sites)
    linears = unstack(params["linear"], n_sites)
    site = {lid: k for k, lid in enumerate(cfg.hybrid_layer_ids)}
    x = emb
    for i, lp in enumerate(layers):
        k = site.get(i)
        if k is None:
            x = layer(lp, x)
        else:
            x = hybrid(lp, blocks[k % cfg.n_shared_blocks], adapters[k], linears[k], x, emb,
                       positions)
    return x


def loss_fn(params, batch, cfg: ModelConfig, *, remat=None):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-100 ignored). Returns (loss, {"ce", "aux"}), aux 0."""
    emb = embed(params["embed"], batch["tokens"])
    h = norm(params["final_norm"], _forward(params, cfg, emb, remat=remat), cfg.norm_eps)
    ce = head_loss(params, h, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def _not_built(*args, **kwargs):
    raise NotImplementedError("the zamba2 family trains only: its serving path (the shared "
                              "blocks' caches, grouped decode states) is not built")


def build(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, init=functools.partial(init, cfg=cfg),
                 loss=functools.partial(loss_fn, cfg=cfg), prefill=_not_built,
                 decode_step=_not_built, init_cache=_not_built)
