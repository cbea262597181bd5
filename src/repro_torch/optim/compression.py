"""Gradient compression for the DP all-reduce: int8 quantization with error
feedback, the port of ``src/repro/optim/compression.py``.

The quantize -> dequantize round trip runs as it would per shard, with the
residual fed back into the next step. ``int8_allreduce`` (the collective
itself) comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.common import tree_map
from .adamw import leaves


class ErrorFeedback(NamedTuple):
    residual: Any     # same structure as grads, fp32


def init(grads_like) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(grads, ef: ErrorFeedback):
    """Error-feedback int8 round trip of a grad tree. Returns
    (decompressed_grads, new_error_feedback, bytes_ratio)."""
    def one(g, r):
        gf = g.float() + r
        deq = dequantize(*quantize(gf))
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, ef.residual)
    new_g = tree_map(lambda p: p[0], pairs)
    new_r = tree_map(lambda p: p[1], pairs)
    flat = leaves(grads)
    in_bytes = sum(g.numel() * g.element_size() for g in flat)
    out_bytes = sum(g.numel() for g in flat)            # int8 payload
    return new_g, ErrorFeedback(new_r), out_bytes / max(in_bytes, 1)
