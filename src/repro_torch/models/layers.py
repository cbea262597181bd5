"""Shared neural-net primitives (plain functions on dict params of tensors).

The port of ``src/repro/models/layers.py``. ``norm`` and ``head_rmsnorm`` go
through ``kernels.ops.rmsnorm``: the Triton kernels on a CUDA tensor (forward,
and the backward where autograd needs it), the plain version on a CPU one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..hints import flag
from ..kernels import ops, sharded
from ..kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain
from ..precision import widen
from ..spans import span

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
    """rmsnorm through the kernel dispatch (Triton on the card), switching to
    the bf16-cotangent backward under the "bf16bwd" flag, as ``repro`` does."""
    if flag("bf16bwd"):
        return rmsnorm_bf16bwd(p["scale"], x, eps)
    return ops.rmsnorm(x, p["scale"], eps=eps)


class _RMSNormBf16Bwd(torch.autograd.Function):
    """Plain rmsnorm with ``repro``'s ``_rms_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, scale, x, eps):
        ctx.save_for_backward(scale, x)
        ctx.eps = eps
        return rmsnorm_plain(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        scale, x = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_plain(x, scale, g, eps=ctx.eps)
        return dscale, dx, None


def rmsnorm_bf16bwd(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm whose backward emits dx in the INPUT dtype (``repro``'s custom
    VJP, ``layers.py:52-83``). On the card this is what ``kernels.ops.rmsnorm``
    already does under autograd (the Triton backward casts dx to x's dtype);
    on the CPU the plain forward with the plain ``_rms_bwd``."""
    if isinstance(x, DTensor):
        return sharded.rmsnorm(x, scale, eps=eps,
                               local=lambda a, s, eps: rmsnorm_bf16bwd(s, a, eps))
    if x.device.type == "cuda":
        return ops.rmsnorm(x, scale, eps=eps)
    return _RMSNormBf16Bwd.apply(scale, x, eps)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: normalize over the head dim. x: (..., hd), scale: (hd,)."""
    return ops.rmsnorm(x, scale, eps=eps)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows of the table. On a vocab-sharded DTensor table each rank
    holds the rows of its own tokens (a masked partial sum); they are summed
    here, so that the residual stream is whole."""
    y = F.embedding(tokens, p["w"])
    if isinstance(y, DTensor) and any(pl.is_partial() for pl in y.placements):
        y = y.redistribute(y.device_mesh, [Replicate() if pl.is_partial() else pl
                                           for pl in y.placements])
    return y


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab. p is the embed table when tied ((V, d)) or an
    unembed matrix ((d, V))."""
    w = p["w"]
    if w.shape[0] == x.shape[-1]:
        return x @ w
    return x @ w.T


def logits(params, h: torch.Tensor) -> torch.Tensor:
    """The model head: ``h`` through the untied ``unembed`` where the model
    has one, the tied ``embed`` table otherwise."""
    return unembed(params.get("unembed", params["embed"]), h)


def head_loss(params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The loss of the final hidden states ``h`` (B,S,d), normed, against
    ``labels`` (B,S): the head and ``cross_entropy_loss`` in the
    ``model.head`` span."""
    with span("model.head"):
        return cross_entropy_loss(logits(params, h), labels)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


def gated_mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32):
    return {"gate_up": dense_init(gen, d, 2 * d_ff, dtype=dtype),
            "down": dense_init(gen, d_ff, d, dtype=dtype)}


def gated_mlp(p, x: torch.Tensor, *, adapter=None) -> torch.Tensor:
    """GELU(gate) * up (the exact, erf GELU) from one fused gate_up product
    (gate its first half), then down; ``adapter`` ({"a", "b"}, a low-rank
    pair, Zamba2's per-site LoRA) adds x a b to gate_up before the split."""
    gu = dense(p["gate_up"], x)
    if adapter is not None:
        gu = gu + dense(adapter["b"], dense(adapter["a"], x))
    gate, up = gu.chunk(2, dim=-1)
    return dense(p["down"], F.gelu(gate) * up)


# -- rotary embeddings ---------------------------------------------------------
def rope_tables(positions: torch.Tensor, hd: int, theta: float, dtype=torch.float32):
    """positions: (S,) int -> cos/sin (S, hd/2), float32 (or ``dtype``)."""
    exps = torch.arange(0, hd, 2, dtype=dtype, device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.to(dtype)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2). Split-half rotation."""
    dt = x.dtype
    x1, x2 = widen(x).chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def sinusoid_embed(S: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positional embeddings (S, d), float32."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean next-token CE over non-ignored positions, float32 logsumexp over
    the whole (padded) vocab. logits (B,S,V), labels (B,S)."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels, ignore_index)
    nll, count = _nll_sum(logits, labels, ignore_index)
    return nll / count.clamp_min(1)


def _nll_sum(logits, labels, ignore_index):
    valid = labels != ignore_index
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    lf = widen(logits)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels_safe[..., None].long())[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def _sharded_cross_entropy(logits: DTensor, labels, ignore_index):
    """The loss on DTensor logits: the vocab made whole on every rank (an
    all-gather over the mesh dims that shard it, as GSPMD does for the
    logsumexp), then the sums of each rank's rows, added across the mesh
    dims that shard the rows."""
    mesh, nd = logits.device_mesh, logits.ndim
    lp = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == nd - 1) else p
          for p in logits.placements]
    if tuple(lp) != tuple(logits.placements):
        logits = logits.redistribute(mesh, lp)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(labels.placements) != tuple(lp):
        labels = labels.redistribute(mesh, lp)
    sums = [Partial() if p.is_shard() else Replicate() for p in lp]
    nll, count = local_map(lambda a, b: _nll_sum(a, b, ignore_index),
                           out_placements=(sums, sums), in_placements=(lp, lp),
                           device_mesh=mesh)(logits, labels)
    return nll / count.clamp_min(1)
