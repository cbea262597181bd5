"""Shared neural-net primitives (plain functions on dict params of tensors).

The port of ``src/repro/models/layers.py`` for the serving path. ``norm`` and
``head_rmsnorm`` go through ``kernels.ops.rmsnorm``: the Triton kernel on a
CUDA tensor, the plain version on a CPU one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.rmsnorm import rmsnorm_plain

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# -- init helpers (random numbers from the caller's generator, on its device) --
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32):
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * (d_in ** -0.5)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    w = torch.randn((vocab, d), generator=gen, device=gen.device) * (d ** -0.5)
    return {"w": w.to(dtype)}


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32):
    return {
        "gate": dense_init(gen, d, d_ff, dtype=dtype),
        "up": dense_init(gen, d, d_ff, dtype=dtype),
        "down": dense_init(gen, d_ff, d, dtype=dtype),
    }


# -- apply helpers ------------------------------------------------------------
def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain rmsnorm on any device: float32 statistics, cast back to x's dtype."""
    return rmsnorm_plain(x, p["scale"], eps=eps)


def norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm through the kernel dispatch (Triton on the card)."""
    return ops.rmsnorm(x, p["scale"], eps=eps)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: normalize over the head dim. x: (..., hd), scale: (hd,)."""
    return ops.rmsnorm(x, scale, eps=eps)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["w"])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab. p is the embed table when tied ((V, d)) or an
    unembed matrix ((d, V))."""
    w = p["w"]
    if w.shape[0] == x.shape[-1]:
        return x @ w
    return x @ w.T


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


# -- rotary embeddings ---------------------------------------------------------
def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """positions: (S,) int -> cos/sin (S, hd/2), float32."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2). Split-half rotation."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)
