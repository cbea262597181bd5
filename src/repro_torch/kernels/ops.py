"""Public kernel entry points: dispatch on the tensor's device, count launches.

The port's counterpart of ``src/repro/kernels/ops.py``. A CPU tensor goes to
the kernel's plain PyTorch version; a CUDA tensor goes to the kernel, which
builds or launches or raises. Nothing falls back from one to the other.

``LAUNCHES`` holds one integer per kernel, raised by one where its wrapper
launches the kernel and nowhere else, so a run can show that its path went
through every kernel (``reset_launches()`` before, read after).
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .rmsnorm import rmsnorm_plain, rmsnorm_triton

KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale; x: (..., d), scale: (d,)."""
    if not _on_cuda(x, "rmsnorm"):
        return rmsnorm_plain(x, scale, eps=eps)
    out = rmsnorm_triton(x, scale, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd)."""
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,1,H,hd); k/v: (B,T,K,hd); attend to cache columns [0, kv_len).

    On the card ``kv_len`` must be a one-element int32 tensor on q's device.
    """
    if not _on_cuda(q, "decode_attention"):
        return decode_attention_plain(q, k, v, kv_len=kv_len, window=window)
    out = decode_attention_cuda(q, k, v, kv_len=kv_len, window=window)
    LAUNCHES["decode_attention"] += 1
    return out
