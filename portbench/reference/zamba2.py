"""Plain float32 reference of Zamba2-7B (the configuration's family
``"zamba2"``), written from the layer equations of transformers'
``modeling_zamba2.py`` (``Zamba2ForCausalLM``) and arXiv:2411.15242.

Mamba2 layers, ``x <- x + mixer(rmsnorm(x + a))``, where ``a`` is zero but
at the layers of ``hybrid_layer_ids``: there the shared block
``shared[k % n_shared_blocks]`` of site k reads rmsnorm(concat(x, embedding))
(``attn_in`` = 2 d wide), runs MHA with RoPE on all ``head_dim`` dimensions
and the softmax scale (head_dim / ``attn_scale_div``)^-1/2, then rmsnorm and
a gated MLP, exact GELU(gate) * up, with the site's low-rank adapter added to
gate_up; its output, through the site's ``linear``, is ``a``. The mixer: in_proj
to [z, x, B, C, dt], a causal depthwise conv with bias and SiLU over
[x, B, C], dt = softplus(dt + dt_bias) (no clamp), A = -exp(A_log), the SSD
scan with B and C in ``ssm_groups`` groups (head h reads group h // (H/G)),
computed in chunks of the published ``chunk_size`` (the program's chunk is
its own), plus D x; then y * silu(z) normalised over each group's channels,
times the norm's scale, and out_proj. A final rmsnorm and the output
projection, the embedding's table where the configuration ties them.

Each layer runs under ``torch.utils.checkpoint``, so that a row of a few
thousand tokens is not kept whole for autograd beside the first steps'
float32 state: the backward recomputes the same float32 operations. Every
product goes through ``ops.Products`` (fp8 operands for the control)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops
from .layout import Leaf, dense_w, index, norm_scale


def _mixer_dims(cfg: dict) -> tuple:
    """(d_inner, heads, head dim, state, groups, conv channels)."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    N, G, P = cfg["ssm_state"], cfg["ssm_groups"], cfg["ssm_head_dim"]
    return di, di // P, P, N, G, di + 2 * G * N


def param_spec(cfg: dict) -> dict:
    d, L, W = cfg["d_model"], cfg["n_layers"], cfg["ssm_conv_width"]
    di, H, _, N, G, conv = _mixer_dims(cfg)
    din, Ha, K, hd = cfg["attn_in"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    ff, r, nb = cfg["d_ff"], cfg["adapter_rank"], cfg["n_shared_blocks"]
    ns = len(cfg["hybrid_layer_ids"])
    spec = {
        "embed": {"w": Leaf((ops.padded_rows(cfg["vocab_size"]), d), "normal", d)},
        "final_norm": norm_scale(d),
        "layers": {
            "norm": norm_scale(d, (L,)),
            "mamba": {"in_proj": dense_w(d, 2 * di + 2 * G * N + H, (L,)),
                      "conv_w": Leaf((L, W, conv), "normal", W),
                      "conv_b": Leaf((L, conv), "zeros"),
                      "dt_bias": Leaf((L, H), "dt_bias", dtype="float32"),
                      "A_log": Leaf((L, H), "a_log", dtype="float32"),
                      "D": Leaf((L, H), "ones", dtype="float32"),
                      "gnorm": norm_scale(di, (L,)),
                      "out_proj": dense_w(di, d, (L,))},
        },
        "shared": {
            "ln1": norm_scale(din, (nb,)),
            "attn": {"wq": dense_w(din, Ha * hd, (nb,)), "wk": dense_w(din, K * hd, (nb,)),
                     "wv": dense_w(din, K * hd, (nb,)), "wo": dense_w(Ha * hd, d, (nb,))},
            "ln2": norm_scale(d, (nb,)),
            "mlp": {"gate_up": dense_w(d, 2 * ff, (nb,)), "down": dense_w(ff, d, (nb,))},
        },
        "adapters": {"a": dense_w(d, r, (ns,)), "b": dense_w(r, 2 * ff, (ns,))},
        "linear": dense_w(d, d, (ns,)),
    }
    if not cfg.get("tie_embeddings"):
        spec["unembed"] = {"w": Leaf((ops.padded_rows(cfg["vocab_size"]), d), "normal", d)}
    return spec


def ssd(x, dt, A, B, C, Q: int, mm: ops.Products) -> torch.Tensor:
    """y of the scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t . h_t, from h = 0, in chunks of Q: x (b, S, H, P), dt (b, S, H),
    A (H,), B and C (b, S, G, N)."""
    b, S, H, P = x.shape
    G, N = B.shape[2:]
    pad = -S % Q                     # identity steps: dt 0, so a = 1 and nothing added
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q
    grp = torch.arange(H, device=x.device) // (H // G)
    L = torch.cumsum((dt * A).reshape(b, nc, Q, H), dim=2)
    xd = (x * dt[..., None]).reshape(b, nc, Q, H, P)
    Bc, Cc = B.reshape(b, nc, Q, G, N), C.reshape(b, nc, Q, G, N)
    # within a chunk: y_t = sum_{s <= t} exp(L_t - L_s) (C_t . B_s) xd_s
    CB = mm.einsum("bcqgn,bcsgn->bcqsg", Cc, Bc)[..., grp]
    seg = L[:, :, :, None, :] - L[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))) * CB
    y = mm.einsum("bcqsh,bcshp->bcqhp", M, xd)
    # each chunk's state from its own steps, then the states carried across
    w = torch.exp(L[:, :, -1:, :] - L)
    states = mm.einsum("bcqhn,bcqhp->bchpn", Bc[:, :, :, grp] * w[..., None], xd)
    h, entering = torch.zeros_like(states[:, 0]), []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(L[:, c, -1, :])[:, :, None, None] * h + states[:, c]
    y = y + mm.einsum("bcqhn,bchpn->bcqhp", Cc[:, :, :, grp],
                      torch.stack(entering, dim=1)) * torch.exp(L)[..., None]
    return y.reshape(b, nc * Q, H, P)[:, :S]


def mixer(p, x, cfg: dict, mm: ops.Products) -> torch.Tensor:
    b, S, _ = x.shape
    di, H, P, N, G, conv = _mixer_dims(cfg)
    z, xBC, dt = mm.einsum("bsd,de->bse", x, p["in_proj"]["w"]).split([di, conv, H], dim=-1)
    W = p["conv_w"].shape[0]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (W - 1, 0)), p["conv_w"].t()[:, None, :],
                   groups=conv).transpose(1, 2) + p["conv_b"]
    xs, B, C = F.silu(xBC).split([di, G * N, G * N], dim=-1)
    xs = xs.reshape(b, S, H, P)
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(xs, dt, -torch.exp(p["A_log"]), B.reshape(b, S, G, N), C.reshape(b, S, G, N),
            cfg["chunk_size"], mm)
    y = (y + p["D"][:, None] * xs).reshape(b, S, di) * F.silu(z)
    g = y.reshape(b, S, G, di // G)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg["norm_eps"])
    return mm.einsum("bse,ed->bsd", g.reshape(b, S, di) * p["gnorm"]["scale"],
                     p["out_proj"]["w"])


def attention(p, x, cfg: dict, cos, sin, mm: ops.Products) -> torch.Tensor:
    """Causal GQA self-attention with RoPE on every dimension of a head and
    the scale (head_dim / attn_scale_div)^-1/2."""
    b, S, _ = x.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = ops.rope(mm.einsum("bsd,de->bse", x, p["wq"]["w"]).reshape(b, S, H, hd), cos, sin)
    k = ops.rope(mm.einsum("bsd,de->bse", x, p["wk"]["w"]).reshape(b, S, K, hd), cos, sin)
    v = mm.einsum("bsd,de->bse", x, p["wv"]["w"]).reshape(b, S, K, hd)
    s = mm.einsum("bskgd,btkd->bkgst", q.reshape(b, S, K, H // K, hd), k)
    s = s * (hd / cfg["attn_scale_div"]) ** -0.5
    future = torch.ones((S, S), dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    o = mm.einsum("bkgst,btkd->bskgd", w, v).reshape(b, S, H * hd)
    return mm.einsum("bse,ed->bsd", o, p["wo"]["w"])


def shared_block(sp, ap, lin, x, emb, cfg: dict, cos, sin, mm: ops.Products) -> torch.Tensor:
    """What a site adds to its mamba layer's input."""
    eps = cfg["norm_eps"]
    h = attention(sp["attn"], ops.rmsnorm(torch.cat([x, emb], dim=-1), sp["ln1"]["scale"], eps),
                  cfg, cos, sin, mm)
    h = ops.rmsnorm(h, sp["ln2"]["scale"], eps)
    gu = mm.einsum("bsd,df->bsf", h, sp["mlp"]["gate_up"]["w"]) + mm.einsum(
        "bsr,rf->bsf", mm.einsum("bsd,dr->bsr", h, ap["a"]["w"]), ap["b"]["w"])
    gate, up = gu.chunk(2, dim=-1)
    h = mm.einsum("bsf,fd->bsd", F.gelu(gate) * up, sp["mlp"]["down"]["w"])
    return mm.einsum("bsd,de->bse", h, lin)


def _layer(lp, x, cfg, mm, add=None):
    h = x if add is None else x + add
    return x + mixer(lp["mamba"], ops.rmsnorm(h, lp["norm"]["scale"], cfg["norm_eps"]), cfg, mm)


def _hybrid(lp, sp, ap, lin, x, emb, cos, sin, cfg, mm):
    return _layer(lp, x, cfg, mm, shared_block(sp, ap, lin, x, emb, cfg, cos, sin, mm))


def hidden(params, tokens, cfg: dict, mm: ops.Products) -> torch.Tensor:
    """The final rmsnorm's output for rows ``tokens`` (b, S): what the output
    projection reads."""
    emb = params["embed"]["w"][tokens]
    cos, sin = ops.rope_tables(tokens.shape[1], cfg["head_dim"], cfg["rope_theta"], emb.device)
    site = {lid: k for k, lid in enumerate(cfg["hybrid_layer_ids"])}
    x = emb
    for i in range(cfg["n_layers"]):
        lp = index(params["layers"], i)
        k = site.get(i)
        if k is None:
            x = checkpoint(_layer, lp, x, cfg, mm, use_reentrant=False)
        else:
            x = checkpoint(_hybrid, lp, index(params["shared"], k % cfg["n_shared_blocks"]),
                           index(params["adapters"], k), params["linear"]["w"][k], x, emb,
                           cos, sin, cfg, mm, use_reentrant=False)
    return ops.rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])


def nll_sum(params, tokens, labels, cfg: dict, mm: ops.Products) -> torch.Tensor:
    """Summed loss of rows ``tokens`` (b, S) against ``labels``."""
    return ops.nll_sum(hidden(params, tokens, cfg, mm),
                       params.get("unembed", params["embed"])["w"], labels, mm)


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, 3 times the
    forward) of ``batch`` rows of ``seq`` tokens. The forward's, a token: 2
    per weight of every product (the mixers' projections and conv, the
    shared blocks' at each site with the site's adapter and ``linear``, the
    output projection over the published vocabulary; not the embedding
    lookup); causal attention's Q.K^T and P.V, 2 H hd for each position of
    the sequence, halved by the mask; and the SSD's products in chunks of
    the published ``chunk_size`` Q: C.B^T and M.x within a chunk (Q N G and
    Q H P, halved by the mask), the chunk's states and the carried states'
    part of y (2 H P N each). Remat's recompute is not counted."""
    d, L, W = cfg["d_model"], cfg["n_layers"], cfg["ssm_conv_width"]
    di, H, P, N, G, conv = _mixer_dims(cfg)
    din, Ha, K, hd = cfg["attn_in"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    ff, r, Q = cfg["d_ff"], cfg["adapter_rank"], cfg["chunk_size"]
    mixer_w = d * (2 * di + 2 * G * N + H) + di * d + W * conv
    site_w = din * (Ha + 2 * K) * hd + Ha * hd * d + 3 * d * ff + r * (d + 2 * ff) + d * d
    ns = len(cfg["hybrid_layer_ids"])
    per_token = (2 * (L * mixer_w + ns * site_w + d * cfg["vocab_size"])
                 + L * (Q * N * G + Q * H * P + 4 * H * P * N) + ns * 2 * Ha * hd * seq)
    return 3.0 * per_token * batch * seq
