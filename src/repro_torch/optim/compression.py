"""Gradient compression for the DP all-reduce: int8 quantization with error
feedback, the port of ``src/repro/optim/compression.py``.

The quantize -> dequantize round trip runs as it would per shard, with the
residual fed back into the next step (on DTensor grads the scale is each
leaf's global max). ``int8_allreduce`` is the collective itself on a
``torch.distributed`` group: int8 is all that goes on the wire.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

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


def _with_scale(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rows of int8 payload (n, m) -> (n, m + 4): the float32 scale's four
    bytes appended to each row, so that the scale travels as int8 too."""
    tail = scale.reshape(1).to(torch.float32).view(torch.int8)
    return torch.cat([q, tail.expand(q.shape[0], 4)], dim=1)


def _split_scale(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return rows[:, :-4], rows[:, -4:].contiguous().view(torch.float32).reshape(-1)


@torch.no_grad()
def int8_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce with int8 wire payloads: the port of ``repro``'s
    ``int8_allreduce`` (there inside ``shard_map``), on ``group``.

    Each rank int8-quantizes its full ``x`` (per-tensor scale), sends chunk
    j to rank j (``all_to_all_single``), sums the chunks it received in
    float32 with their senders' scales, divides by the group size,
    re-quantizes that chunk, and every rank gathers every chunk
    (``all_gather_into_tensor``). Each row on the wire is int8, its scale's
    four bytes appended: ~2*|x| bytes a rank where a float32 ring all-reduce
    moves ~8*|x|. ``x``: the rank's full tensor; flattened and padded to a
    multiple of the group size inside."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    flat = F.pad(flat, (0, pad))
    q, scale = quantize(flat)
    send = _with_scale(q.reshape(n, -1), scale)                   # (n, chunk + 4) int8
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)               # row j: my chunk, from j
    got, scales = _split_scale(recv)
    part = (got.to(torch.float32) * scales[:, None]).sum(dim=0) / n
    q2, s2 = quantize(part)
    mine = _with_scale(q2[None], s2)                              # (1, chunk + 4)
    full = torch.empty((n, mine.shape[1]), dtype=torch.int8, device=x.device)
    dist.all_gather_into_tensor(full, mine, group=group)
    fq, fs = _split_scale(full)
    out = (fq.to(torch.float32) * fs[:, None]).reshape(-1)[:x.numel()]
    return out.reshape(x.shape).to(x.dtype)


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
