"""Carry parameters from ``repro``'s tree of arrays into the port.

``repro``'s params are nested dicts of arrays; handed over as nested dicts of
numpy arrays, they become the port's nested dicts of tensors with the same
key paths and the same stacked leading layer dims (``layers/attn/wq/w`` is
(L, d, H*hd) on both sides). numpy has no bfloat16 of its own, so a caller
holding bf16 arrays widens them to float32 first and passes ``dtype``.

``repro`` keeps some leaves in float32 whatever the config's dtype: Mamba2's
``dt_bias``, ``A_log`` and ``D`` (``src/repro/models/mamba2.py:mamba_init``).
Those stay float32 when ``dtype`` asks for another type; the dense tree has
none of them.
"""

from __future__ import annotations

import numpy as np
import torch

FLOAT32_LEAVES = frozenset({"dt_bias", "A_log", "D"})


def from_numpy(tree, *, device="cpu", dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``,
    cast to ``dtype`` where given, except the ``FLOAT32_LEAVES``, which are
    float32."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))      # a writable, contiguous copy
        if dtype is None:
            return t.to(device)
        return t.to(device=device, dtype=torch.float32 if key in FLOAT32_LEAVES else dtype)
    return walk(tree, "")
