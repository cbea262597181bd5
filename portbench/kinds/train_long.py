"""The training kind for rows too long for the reference to keep its
attention for autograd: ``train``'s run, with the reference's causal
attention (``reference/ops.causal_attention``) recomputed in the backward
(``torch.utils.checkpoint``) instead of its scores and probabilities kept.
At phi4-mini's 24 heads a row of 8,192 tokens keeps 6.4 GB of float32
probabilities a layer, 52 GB over 8 layers beside the first steps' 28 GB of
float32 state; recomputed, one layer's at a time. The recompute repeats the
same float32 operations, so the readings are those ``train`` gives where the
card holds them all. Nothing of the program changes."""

from __future__ import annotations

import contextlib

import torch.utils.checkpoint

from ..reference import ops
from . import train


@contextlib.contextmanager
def recomputed_attention():
    """``ops.causal_attention`` under ``torch.utils.checkpoint`` inside the
    block; restored on the way out."""
    plain = ops.causal_attention

    def attention(*args):
        return torch.utils.checkpoint.checkpoint(plain, *args, use_reentrant=False)
    ops.causal_attention = attention
    try:
        yield
    finally:
        ops.causal_attention = plain


def run(*args, **kwargs) -> dict:
    """``train.run`` with the reference's attention recomputed."""
    with recomputed_attention():
        return train.run(*args, **kwargs)
