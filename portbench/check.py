"""The numbers that decide ``correct``: the program's first training steps
against the float32 reference's from the same weights and batches.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: the worst leaf's gap between the two norms of its first
  gradient as the optimizer takes it, over the reference's norm of that
  leaf or of the median leaf, whichever is larger.
- ``change_gap``: the same of each leaf's change after the last step,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

A cell's limits file gives each a limit.

A leaf left unmoved, or a step that leaves the state as it was, reads 1.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _leaf_gaps(got: dict, want: dict, keys) -> list:
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    gaps = [abs(got.get(k, math.nan) - want[k]) / max(want[k], med, 1e-30) for k in keys]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def gaps(got: dict, want: dict) -> dict:
    """The numbers of readings ``got`` against the reference's ``want``
    (each {"loss": [...], "grad": {leaf: norm}, "change": {leaf: norm}})."""
    loss = max((abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"])),
               default=math.inf)
    if len(got["loss"]) != len(want["loss"]) or not math.isfinite(loss):
        loss = math.inf
    med = statistics.median(want["grad"].values())
    moved = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
    grad = _leaf_gaps(got["grad"], want["grad"], want["grad"])
    change = _leaf_gaps(got["change"], want["change"], moved)
    return {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number with a limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and bool(checks), checks
