"""Public kernel entry points: dispatch on the tensor's device, count launches.

The port's counterpart of ``src/repro/kernels/ops.py``. A CPU tensor goes to
the kernel's plain PyTorch version; a CUDA tensor goes to the kernel, which
builds or launches or raises. Nothing falls back from one to the other.

``LAUNCHES`` holds one integer per kernel, raised by one where its wrapper
launches the kernel and nowhere else, so a run can show that its path went
through every kernel (``reset_launches()`` before, read after).

Training: where autograd needs a gradient of ``rmsnorm``,
``flash_attention``, ``ssd_intra_chunk`` or ``causal_conv_silu`` on the
card, the call goes through a ``torch.autograd.Function`` whose forward
launches the forward kernel (which also writes what the backward reads:
each row's ``inv``, or its log-sum-exp) and whose backward launches the
backward kernel (``rmsnorm_bwd``, ``flash_attention_bwd``,
``ssd_intra_chunk_bwd``, ``causal_conv_silu_bwd``).
Without a gradient (``inference_mode``, serving) the forward kernels launch
exactly as before. On the CPU autograd runs through the plain versions.

DTensors (the sharded steps of ``runtime/parallel.py``) go to
``kernels/sharded.py``, which runs these same entry points on each rank's
local shards through ``local_map`` where the placements make that exact,
and raises on any other placement.

The optimizer's ``adamw`` (one leaf's fused update) and ``grad_sumsq`` (the
clip's sum of squares, one launch a leaf) send DTensors, as CPU tensors, to
their plain versions: the norm is then the whole tensor's on every rank.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from .adamw import adamw_plain, adamw_triton, grad_sumsq_plain, grad_sumsq_triton
from .causal_conv import (
    causal_conv_silu_bwd_triton,
    causal_conv_silu_plain,
    causal_conv_silu_triton,
)
from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    flash_attention_plain,
)
from .rmsnorm import rmsnorm_bwd_triton, rmsnorm_plain, rmsnorm_triton
from . import sharded
from .ssd_scan import ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda, ssd_intra_chunk_plain

KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssd_intra_chunk",
           "rmsnorm_bwd", "flash_attention_bwd", "ssd_intra_chunk_bwd", "adamw", "grad_sumsq",
           "causal_conv_silu", "causal_conv_silu_bwd")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RMSNorm(torch.autograd.Function):
    """The Triton forward saving each row's inv; the Triton backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, inv = rmsnorm_triton(x, scale, eps=eps, return_inv=True)
        LAUNCHES["rmsnorm"] += 1
        ctx.save_for_backward(x, scale, inv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_triton(x, scale, g.contiguous(), inv)
        LAUNCHES["rmsnorm_bwd"] += 1
        return dx, dscale, None


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward writing each row's log-sum-exp; the CUDA backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True,
                                        softmax_scale=softmax_scale)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softmax_scale = causal, window, softmax_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                              causal=ctx.causal, window=ctx.window,
                                              softmax_scale=ctx.softmax_scale)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


class _SSDIntraChunk(torch.autograd.Function):
    """The CUDA forward; the CUDA backward (an output autograd leaves
    without a gradient, ``tot`` in the model, comes in as zeros)."""

    @staticmethod
    def forward(ctx, la, C, B_in, x):
        out = ssd_intra_chunk_cuda(la, C, B_in, x)
        LAUNCHES["ssd_intra_chunk"] += 1
        ctx.save_for_backward(la, C, B_in, x)
        return out

    @staticmethod
    def backward(ctx, dy, dstates, dtot):
        grads = ssd_intra_chunk_bwd_cuda(*ctx.saved_tensors, dy.contiguous(),
                                         dstates.contiguous(), dtot.contiguous())
        LAUNCHES["ssd_intra_chunk_bwd"] += 1
        return grads


class _CausalConvSiLU(torch.autograd.Function):
    """The Triton forward saving only its inputs; the Triton backward, which
    recomputes the conv from x."""

    @staticmethod
    def forward(ctx, x, w, b):
        out = causal_conv_silu_triton(x, w, b)
        LAUNCHES["causal_conv_silu"] += 1
        ctx.save_for_backward(x, w, b)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        grads = causal_conv_silu_bwd_triton(x, w, b, dy if dy.stride(-1) == 1 else dy.contiguous())
        LAUNCHES["causal_conv_silu_bwd"] += 1
        return grads


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale; x: (..., d), scale: (d,)."""
    if isinstance(x, DTensor):
        return sharded.rmsnorm(x, scale, eps=eps, local=rmsnorm)
    if not _on_cuda(x, "rmsnorm"):
        return rmsnorm_plain(x, scale, eps=eps)
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    out = rmsnorm_triton(x, scale, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd); the scores are q . k
    times ``softmax_scale`` (default hd^-1/2)."""
    if isinstance(q, DTensor):
        return sharded.flash_attention(q, k, v, causal=causal, window=window,
                                       local=functools.partial(flash_attention,
                                                               softmax_scale=softmax_scale))
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softmax_scale=softmax_scale)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softmax_scale)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               softmax_scale=softmax_scale)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len, window: Optional[int] = None, return_lse: bool = False):
    """q: (B,1,H,hd); k/v: (B,T,K,hd); attend to cache columns [0, kv_len).
    With ``return_lse`` also each row's log-sum-exp, float32 (B, H).

    On the card ``kv_len`` must be a one-element int32 tensor on q's device.
    """
    if isinstance(q, DTensor):
        if return_lse:
            raise ValueError("decode_attention on DTensors merges the lse itself")
        return sharded.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                        local=decode_attention)
    if not _on_cuda(q, "decode_attention"):
        return decode_attention_plain(q, k, v, kv_len=kv_len, window=window,
                                      return_lse=return_lse)
    out = decode_attention_cuda(q, k, v, kv_len=kv_len, window=window, return_lse=return_lse)
    LAUNCHES["decode_attention"] += 1
    return out


def ssd_intra_chunk(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor, x: torch.Tensor):
    """la: (B,nc,Q,H); C/B_in: (B,nc,Q,G,N), G groups of heads (head h
    reads group h // (H/G)); x: (B,nc,Q,H,P) ->
    (y (B,nc,Q,H,P), states (B,nc,H,P,N), tot (B,nc,H)), float32."""
    if isinstance(la, DTensor):
        return sharded.ssd_intra_chunk(la, C, B_in, x, local=ssd_intra_chunk)
    if not _on_cuda(la, "ssd_intra_chunk"):
        return ssd_intra_chunk_plain(la, C, B_in, x)
    if _wants_grad(la, C, B_in, x):
        return _SSDIntraChunk.apply(la, C, B_in, x)
    out = ssd_intra_chunk_cuda(la, C, B_in, x)
    LAUNCHES["ssd_intra_chunk"] += 1
    return out


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(depthwise causal conv(x, w) + b): x (B, S, Ch), any row stride on
    the card; w (W, Ch); b (Ch,) -> (B, S, Ch) contiguous, in x's dtype."""
    if isinstance(x, DTensor):
        return sharded.depthwise_conv(x, w, b, local=causal_conv_silu)
    if not _on_cuda(x, "causal_conv_silu"):
        return causal_conv_silu_plain(x, w, b)
    if _wants_grad(x, w, b):
        return _CausalConvSiLU.apply(x, w, b)
    out = causal_conv_silu_triton(x, w, b)
    LAUNCHES["causal_conv_silu"] += 1
    return out


def adamw(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, mw: torch.Tensor,
          p: torch.Tensor, hyper: torch.Tensor, *, b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """One AdamW step of one leaf in place: float32 m, v and master weights
    ``mw``, and the param ``p`` cast from the new ``mw``. ``hyper``: float32
    (4,) on the leaf's device, (clip scale, lr, bias correction 1, bias
    correction 2)."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if isinstance(m, DTensor) or not _on_cuda(m, "adamw"):
        adamw_plain(g, m, v, mw, hyper, **kw)
        p.copy_(mw)
        return
    adamw_triton(g, m, v, mw, p, hyper, **kw)
    LAUNCHES["adamw"] += 1


def grad_sumsq(grads: list) -> torch.Tensor:
    """The float32 sum over the leaves ``grads`` of sum(g^2), 0-dim, on
    their device."""
    if any(isinstance(g, DTensor) for g in grads) or not _on_cuda(grads[0], "grad_sumsq"):
        return grad_sumsq_plain(grads)
    total = grad_sumsq_triton(grads)
    LAUNCHES["grad_sumsq"] += len(grads)
    return total
