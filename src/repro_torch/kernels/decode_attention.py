"""Single-token decode attention over a KV cache: the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel, ``csrc/decode_attention.cu``, replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``. On the H100 it is
bound by the bytes of the valid cache prefix; its header says what the
design does about that. ``kv_len`` is a device int32 tensor, so a step needs
no value from the host. Unlike the TPU kernel it takes any cache length T.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .flash_attention import DTYPE_CODES, HEAD_DIMS

_NEG = -2.0e38
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "decode_attention_fwd": [_P] * 8 + [_I] * 7 + [_P],
    "decode_attention_nsplit": [_I],
}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           kv_len, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,1,H,hd); k/v: (B,T,K,hd); attend to [0, kv_len) (an int or a
    0-dim integer tensor). Returns (B,1,H,hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (hd ** -0.5)
    cols = torch.arange(T, device=q.device)
    ok = cols < kv_len
    if window is not None:
        ok = ok & (cols > kv_len - 1 - window)
    s = torch.where(ok, s, torch.tensor(_NEG, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, hd)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_len: torch.Tensor, window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernels (split + combine) on PyTorch's current stream.

    ``kv_len``: an int32 tensor of one element on q's device."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous q, k and v")
    if (not isinstance(kv_len, torch.Tensor) or kv_len.dtype != torch.int32
            or kv_len.numel() != 1 or kv_len.device != q.device):
        raise ValueError("kv_len must be a one-element int32 tensor on q's device")
    lib = build.library("decode_attention", _SIGNATURES)
    nsplit = lib.decode_attention_nsplit(T)
    out = torch.empty_like(q)
    part_m = torch.empty(B * H * nsplit, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * nsplit * hd, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, T, H, K, hd, -1 if window is None else int(window), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention_fwd")
    return out
