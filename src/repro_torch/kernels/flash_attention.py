"""Flash attention forward (GQA, causal / sliding window): the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention``. On the H100 it is
bound by operations; its header says what the design does about that. Unlike
the TPU kernel it takes any S and T: ragged tiles are masked in the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_NEG = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": [_P] * 4 + [_I] * 9 + [_P]}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd). Full-softmax GQA with
    float32 scores, -2e38 masking, weights cast to v's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (hd ** -0.5)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    ok = cols <= rows if causal else torch.ones((S, T), dtype=torch.bool, device=q.device)
    if window is not None:
        ok = ok & (cols > rows - window)
    s = torch.where(ok, s, torch.tensor(_NEG, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, hd)


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, int(causal), -1 if window is None else int(window),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    return out
