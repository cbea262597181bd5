"""Plain operations of the references, in float32 with TF32 off, or, for the
control, with every product's operands in fp8 (``Products("fp8")``): e4m3
operands in the forward, e5m2 incoming gradients in the backward, each
scaled by its own tensor's largest magnitude, products summed in float32,
as fp8 training runs them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _quantize(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under a per-tensor scale, back in t's dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(fmt).max / amax
    return ((t * scale).to(fmt).to(t.dtype) / scale)


class _Operand(torch.autograd.Function):
    """e4m3 in the forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return _quantize(t, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """Identity in the forward; the incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, E5M2)


class Products:
    """``einsum`` in float32 (``"float32"``) or on fp8 operands (``"fp8"``)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return torch.einsum(eq, a, b)
        return _Result.apply(torch.einsum(eq, _Operand.apply(a), _Operand.apply(b)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope_tables(S: int, hd: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (S, hd/2) of position p times theta^(-2i/hd)."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of each head (b, S, heads, hd)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(p, x, cfg: dict, cos, sin, mm: Products) -> torch.Tensor:
    """GQA self-attention with RoPE and a causal softmax: x (b, S, d)."""
    b, S, _ = x.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm.einsum("bsd,de->bse", x, p["wq"]["w"]).reshape(b, S, K, H // K, hd)
    k = mm.einsum("bsd,de->bse", x, p["wk"]["w"]).reshape(b, S, K, hd)
    v = mm.einsum("bsd,de->bse", x, p["wv"]["w"]).reshape(b, S, K, hd)
    q = rope(q.reshape(b, S, H, hd), cos, sin).reshape(b, S, K, H // K, hd)
    k = rope(k, cos, sin)
    s = mm.einsum("bskgd,btkd->bkgst", q, k) * hd ** -0.5
    future = torch.ones((S, S), dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    o = mm.einsum("bkgst,btkd->bskgd", w, v).reshape(b, S, H * hd)
    return mm.einsum("bse,ed->bsd", o, p["wo"]["w"])


def swiglu(p, x, mm: Products) -> torch.Tensor:
    gate = mm.einsum("bsd,df->bsf", x, p["gate"]["w"])
    up = mm.einsum("bsd,df->bsf", x, p["up"]["w"])
    return mm.einsum("bsf,fd->bsd", F.silu(gate) * up, p["down"]["w"])


def nll_sum(h, table, labels, mm: Products) -> torch.Tensor:
    """Summed next-token negative log-likelihood of ``labels`` under the
    logits h · tableᵀ over every row of the table (b, S, rows)."""
    logits = mm.einsum("bsd,vd->bsv", h, table)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def padded_rows(vocab: int) -> int:
    """The program's embedding tables hold the vocabulary rounded up to a
    multiple of 256 rows; the loss's softmax runs over all of them."""
    return (vocab + 255) // 256 * 256
