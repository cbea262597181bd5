"""Single-token decode attention over a KV cache: the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel, ``csrc/decode_attention.cu``, replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``. On the H100 it is
bound by the bytes of the valid cache prefix; its header says what the
design does about that. ``kv_len`` is a device int32 tensor, and the split
plan depends only on (B, K, T) and the card, so a step needs no value from
the host. Unlike the TPU kernel it takes any cache length T.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .flash_attention import DTYPE_CODES

HEAD_DIMS = (64, 112, 128, 256)     # the decode kernel's (flash also takes 224)
_NEG = -2.0e38
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, kv_len, out, lse (or null), scratch; B, T, H, K, hd, window, chunk, dtype; stream
_SIGNATURES = {"decode_attention_fwd": [_P] * 7 + [_I] * 8 + [_P]}
F32_CHUNK = 64          # the float32 kernel's fixed chunk (CH in the source)
BLOCKS_PER_SM = 4


def plan_splits(B: int, K: int, T: int, sm_count: int) -> tuple[int, int]:
    """(chunk, nsplit) for the bf16 split kernel: cache rows per block, a
    multiple of 16, so that B*K*nsplit is about ``BLOCKS_PER_SM`` blocks a
    SM. Depends only on the shapes and the card, never on ``kv_len``."""
    want = max(1, (BLOCKS_PER_SM * sm_count) // (B * K))
    chunk = 16 * -(-T // (16 * want))
    return chunk, -(-T // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_args(q, k, v, kv_len, out, lse, scratch, window, chunk, stream) -> tuple:
    """The arguments of ``decode_attention_fwd``, in its order."""
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), scratch.data_ptr(), B, T, H, K, hd,
            -1 if window is None else int(window), chunk, DTYPE_CODES[q.dtype], stream)


def scratch_numel(B: int, H: int, hd: int, nsplit: int) -> int:
    """Floats of the partials buffer: m and l (B*H*nsplit each), then acc."""
    return B * H * nsplit * (hd + 2)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           kv_len, window: Optional[int] = None, return_lse: bool = False):
    """q: (B,1,H,hd); k/v: (B,T,K,hd); attend to [0, kv_len) (an int or a
    0-dim integer tensor). Returns (B,1,H,hd), and with ``return_lse`` also
    each row's log-sum-exp of its scaled scores, float32 (B, H). Where no
    column is valid (``kv_len`` <= 0) the output is 0 and the lse -inf, as
    the kernel gives them."""
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
    any_ok = ok.any()
    out = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, hd)
    out = torch.where(any_ok, out, torch.zeros((), dtype=out.dtype, device=out.device))
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    return out, torch.where(any_ok, lse, torch.full((), float("-inf"), device=lse.device))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_len: torch.Tensor, window: Optional[int] = None,
                          return_lse: bool = False):
    """Launch the CUDA kernels (split + combine) on PyTorch's current stream.

    ``kv_len``: an int32 tensor of one element on q's device. bf16 splits
    the cache as ``plan_splits`` says, float32 in chunks of ``F32_CHUNK``.
    With ``return_lse`` the combine pass also writes each row's log-sum-exp
    (float32 (B, H); -inf where no column is valid), returned after the
    output."""
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
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("decode_attention_cuda needs q, k and v on 16-byte boundaries")
    if (not isinstance(kv_len, torch.Tensor) or kv_len.dtype != torch.int32
            or kv_len.numel() != 1 or kv_len.device != q.device):
        raise ValueError("kv_len must be a one-element int32 tensor on q's device")
    lib = build.library("decode_attention", _SIGNATURES)
    if q.dtype == torch.bfloat16:
        chunk, nsplit = plan_splits(B, K, T, _sm_count(q.device.index))
    else:
        chunk, nsplit = F32_CHUNK, -(-T // F32_CHUNK)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    scratch = torch.empty(scratch_numel(B, H, hd, nsplit), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(*_fwd_args(
            q, k, v, kv_len, out, lse, scratch, window, chunk,
            torch.cuda.current_stream(q.device).cuda_stream))
    build.check(lib, err, "decode_attention_fwd")
    return (out, lse) if return_lse else out
