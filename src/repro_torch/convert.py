"""Carry parameters from ``repro``'s tree of arrays into the port.

``repro``'s params are nested dicts of arrays; handed over as nested dicts of
numpy arrays, they become the port's nested dicts of tensors with the same
key paths and the same stacked leading layer dims (``layers/attn/wq/w`` is
(L, d, H*hd) on both sides). numpy has no bfloat16 of its own, so a caller
holding bf16 arrays widens them to float32 first and passes ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(tree, *, device="cpu", dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``,
    cast to ``dtype`` where given."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))      # a writable, contiguous copy
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)

