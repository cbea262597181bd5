"""Plain float32 reference of the dense decoder (phi4-mini's family): token
embedding, pre-norm blocks of GQA attention with RoPE and a SwiGLU MLP, a
final rmsnorm, the output projection and the next-token loss.

Departures from the published model are the program's, and are kept here
so that the two compute the same function: RoPE turns every dimension of a
head, and the softmax of the loss runs over the padded table
(``ops.padded_rows``). The output projection is the embedding's table
where the configuration ties them, as phi4-mini does."""

from __future__ import annotations

import torch

from . import ops
from .layout import Leaf, dense_w, index, norm_scale


def param_spec(cfg: dict) -> dict:
    d, H, K, hd, ff, L = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                          cfg["d_ff"], cfg["n_layers"])
    rows = ops.padded_rows(cfg["vocab_size"])
    spec = {
        "embed": {"w": Leaf((rows, d), "normal", d)},
        "final_norm": norm_scale(d),
        "layers": {
            "attn": {"wq": dense_w(d, H * hd, (L,)), "wk": dense_w(d, K * hd, (L,)),
                     "wv": dense_w(d, K * hd, (L,)), "wo": dense_w(H * hd, d, (L,))},
            "ln1": norm_scale(d, (L,)),
            "ln2": norm_scale(d, (L,)),
            "mlp": {"gate": dense_w(d, ff, (L,)), "up": dense_w(d, ff, (L,)),
                    "down": dense_w(ff, d, (L,))},
        },
    }
    if not cfg.get("tie_embeddings"):
        spec["unembed"] = {"w": Leaf((rows, d), "normal", d)}
    return spec


def nll_sum(params, tokens, labels, cfg: dict, mm: ops.Products) -> torch.Tensor:
    """Summed loss of rows ``tokens`` (b, S) against ``labels``."""
    eps = cfg["norm_eps"]
    x = params["embed"]["w"][tokens]
    cos, sin = ops.rope_tables(tokens.shape[1], cfg["head_dim"], cfg["rope_theta"], x.device)
    for i in range(cfg["n_layers"]):
        lp = index(params["layers"], i)
        x = x + ops.causal_attention(lp["attn"], ops.rmsnorm(x, lp["ln1"]["scale"], eps), cfg,
                                     cos, sin, mm)
        x = x + ops.swiglu(lp["mlp"], ops.rmsnorm(x, lp["ln2"]["scale"], eps), mm)
    h = ops.rmsnorm(x, params["final_norm"]["scale"], eps)
    return ops.nll_sum(h, params.get("unembed", params["embed"])["w"], labels, mm)


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward) of ``batch``
    rows of ``seq`` tokens: 6 per weight of every product a token, the
    output projection over the published vocabulary included and the
    embedding lookup excluded, plus causal attention's Q·Kᵀ and P·V: 12·H·hd
    a layer and token for each position of the sequence, halved by the
    causal mask. Remat's recompute is not counted."""
    d, H, K, hd, ff, L = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                          cfg["d_ff"], cfg["n_layers"])
    per_layer = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * ff
    weights = L * per_layer + d * cfg["vocab_size"]
    tokens = batch * seq
    return 6.0 * weights * tokens + 6.0 * L * H * hd * seq * tokens
