"""The working precision of the port's plain paths.

Statistics, scores, rope angles, the loss and the SSD block run in float32
for bfloat16, float16 and float32 inputs, as ``repro`` runs them, and in
float64 for float64 inputs, so that a reference can hold a float32 run to
the same function in float64 (``chip_smoke.py``'s zamba2 train reference).
"""

from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``compute_dtype(t.dtype)``: ``t.float()`` unless float64."""
    return t.to(compute_dtype(t.dtype))
