"""The training kind for models with leaves too large for the reference's
AdamW to take whole beside the first steps' float32 state: ``train``'s run,
with ``reference/adamw.update`` given every leaf as slices of at most
``SLICE`` elements. The slices are views, so its in-place updates land in
the leaves. Its clip norm sums each slice's float64 sum of squares, where it
summed each leaf's; everything else it computes is elementwise and the
same. Zamba2-7B's stacked ``in_proj`` at 24 layers holds 1.26 G elements:
whole, its float64 copy and the copy's square take 20 GB beside 54.7 GB of
state (20 B a parameter); in slices, 1 GB. Nothing of the program
changes."""

from __future__ import annotations

import contextlib

from ..reference import adamw
from . import train

SLICE = 1 << 26


def _slices(tensors: list) -> list:
    return [s for t in tensors for s in t.view(-1).split(SLICE)]


@contextlib.contextmanager
def sliced_update():
    """``adamw.update`` on the leaves' slices inside the block; restored on
    the way out."""
    plain = adamw.update

    def update(params, grads, m, v, step, opt):
        plain(*(_slices(ts) for ts in (params, grads, m, v)), step, opt)
    adamw.update = update
    try:
        yield
    finally:
        adamw.update = plain


def run(*args, **kwargs) -> dict:
    """``train.run`` with the reference's AdamW on slices of the leaves."""
    with sliced_update():
        return train.run(*args, **kwargs)
