"""Public kernel entry points: dispatch on the tensor's device, count launches.

The port's counterpart of ``src/repro/kernels/ops.py``. A CPU tensor goes to
the kernel's plain PyTorch version; a CUDA tensor goes to the kernel, which
builds or launches or raises. Nothing falls back from one to the other.

``LAUNCHES`` holds one integer per kernel, raised by one where its wrapper
launches the kernel and nowhere else, so a run can show that its path went
through every kernel (``reset_launches()`` before, read after).

Training: where autograd needs a gradient of ``rmsnorm``,
``flash_attention`` or ``ssd_intra_chunk`` on the card, the call goes
through a ``torch.autograd.Function`` whose forward launches the forward
kernel (which also writes what the backward reads: each row's ``inv``, or
its log-sum-exp) and whose backward launches the backward kernel
(``rmsnorm_bwd``, ``flash_attention_bwd``, ``ssd_intra_chunk_bwd``).
Without a gradient (``inference_mode``, serving) the forward kernels launch
exactly as before. On the CPU autograd runs through the plain versions.

DTensors (the sharded steps of ``runtime/parallel.py``) go to
``kernels/sharded.py``, which runs these same entry points on each rank's
local shards through ``local_map`` where the placements make that exact,
and raises on any other placement.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

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
           "rmsnorm_bwd", "flash_attention_bwd", "ssd_intra_chunk_bwd")
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
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                              causal=ctx.causal, window=ctx.window)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None


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
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd)."""
    if isinstance(q, DTensor):
        return sharded.flash_attention(q, k, v, causal=causal, window=window,
                                       local=flash_attention)
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
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
    """la: (B,nc,Q,H); C/B_in: (B,nc,Q,N); x: (B,nc,Q,H,P) ->
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
