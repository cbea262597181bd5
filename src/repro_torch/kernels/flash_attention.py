"""Flash attention (GQA, causal / sliding window): the CUDA kernels' wrappers
and their plain PyTorch versions, forward and backward.

The forward kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention``. On the H100 its
bound at the serving and training shapes is the bytes of q, k, v and o (just
above the causal flops on the bf16 tensor cores); its header says what the
design does about that. Unlike the TPU kernel it takes any S and T: ragged
tiles are masked in the kernel. For training it also writes the log-sum-exp
of each row, which the backward kernel, ``csrc/flash_attention_bwd.cu``,
reads; the TPU kernel has no backward (``repro`` trains through its plain
path), so that one has no TPU counterpart and is bound by operations.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..precision import widen
from . import build

_NEG = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS           # the backward kernel's (hd 256: gemma3)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": [_P] * 5 + [_I] * 9 + [_P]}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 11 + [_I] * 9 + [_P]}


def _scores(q, k, causal, window):
    """Masked float32 (float64 for float64 inputs) scores (B, K, G, S, T) and
    the mask (S, T)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    s = widen(torch.einsum("bskgd,btkd->bkgst", qg, k)) * (hd ** -0.5)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    ok = cols <= rows if causal else torch.ones((S, T), dtype=torch.bool, device=q.device)
    if window is not None:
        ok = ok & (cols > rows - window)
    return torch.where(ok, s, torch.tensor(_NEG, dtype=s.dtype, device=s.device)), ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd). Full-softmax GQA with
    float32 scores, -2e38 masking, weights cast to v's dtype."""
    B, S, H, hd = q.shape
    s, _ = _scores(q, k, causal, window)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, hd)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """The log-sum-exp of each row's masked scores, (B,H,S) float32: what the
    forward kernel writes for the backward (scores from q and k widened to
    float32, as the kernels' products accumulate)."""
    B, S, H, _ = q.shape
    s, _ = _scores(widen(q), widen(k), causal, window)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: Optional[int] = None):
    """The backward in its explicit form, float32 inside (q, k, v, o and dout
    widened): P = exp(s - lse) (0 where masked), D = rowsum(dO * O),
    dV = P^T dO with P rounded to v's dtype, dS = P * (dO V^T - D),
    dK = dS^T Q / sqrt(hd), dQ = dS K / sqrt(hd). Returns (dq, dk, dv) in the
    inputs' dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    s, ok = _scores(widen(q), widen(k), causal, window)
    p = torch.where(ok, torch.exp(s - lse.reshape(B, K, G, S, 1)),
                    torch.zeros((), dtype=s.dtype, device=q.device))
    do = widen(dout).reshape(B, S, K, G, hd)
    D = (do * widen(o).reshape(B, S, K, G, hd)).sum(-1).permute(0, 2, 3, 1)   # (B,K,G,S)
    dv = torch.einsum("bkgst,bskgd->btkd", widen(p.to(v.dtype)), do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, widen(v))
    ds = p * (dp - D[..., None])
    scale = hd ** -0.5
    dk = torch.einsum("bkgst,bskgd->btkd", ds, widen(q).reshape(B, S, K, G, hd)) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, widen(k)).reshape(B, S, H, hd) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k and v")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention_cuda needs q, k and v on 16-byte boundaries")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream. With ``return_lse``
    the kernel also writes each row's log-sum-exp: returns (out, lse (B,H,S)
    float32)."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, T, H, K, hd, int(causal), -1 if window is None else int(window),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None):
    """Launch the backward kernel: (dq, dk, dv) in the inputs' dtype. ``o`` and
    ``lse`` are the forward's outputs, ``dout`` the gradient of ``o``."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be a contiguous CUDA "
                             f"tensor shaped and typed like q")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda: lse must be (B,H,S) float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    f32 = dict(dtype=torch.float32, device=q.device)
    D = torch.empty((B, H, S), **f32)
    dq_acc = torch.empty(q.shape, **f32)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.library("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, T, H, K, hd, int(causal), -1 if window is None else int(window),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd")
    return dq, dk, dv
