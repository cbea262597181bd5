"""The first steps of training under a reference, in blocks of rows, and
what the check reads of them: each step's loss, each leaf's first gradient
as the optimizer takes it (after clipping) and each leaf's change after the
last step.

The parameters are what the configuration states: float32 master weights
updated by AdamW, and the model's parameters their values in each leaf's
own dtype (bf16 for the configurations here), which the forward takes;
every product and sum is float32 (or, for the control, on fp8 operands)."""

from __future__ import annotations

import torch

from . import adamw
from .layout import unflatten
from .ops import Products


def first_steps(family, cfg: dict, opt: dict, make_weights, batches: list, *,
                precision: str = "float32", rows: int = 1) -> dict:
    """``make_weights()``: {path: tensor} of the initial weights, each in its
    parameter's dtype, the same at every call (it is called again for the
    change, so that they are not kept); ``batches``: a list of (tokens,
    labels) (B, S) int64 on the weights' device. Takes one step a batch and
    returns the readings."""
    mm = Products(precision)
    weights = make_weights()
    paths = sorted(weights)
    dtypes = [weights[p].dtype for p in paths]
    masters = [weights[p].float() for p in paths]
    del weights
    leaves = [mw.clone().requires_grad_(True) for mw in masters]
    tree = unflatten(zip(paths, leaves))
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, grad = [], {}
    for step, (tokens, labels) in enumerate(batches, start=1):
        total = labels.numel()
        loss = torch.zeros((), dtype=torch.float64, device=labels.device)
        for r in range(0, tokens.shape[0], rows):
            nll = family.nll_sum(tree, tokens[r:r + rows], labels[r:r + rows], cfg, mm)
            (nll / total).backward()
            loss += nll.detach().double()
        adamw.update(masters, [p.grad for p in leaves], m, v, step, opt)
        for p, mw, dt in zip(leaves, masters, dtypes):
            p.grad = None
            p.data.copy_(mw.to(dt))
        losses.append(float(loss / total))
        if step == 1:
            grad = {p: float(mi.norm()) / (1 - opt["b1"]) for p, mi in zip(paths, m)}
    del leaves, tree, m, v
    init = make_weights()
    change = {p: float((mw - init[p].float()).norm()) for p, mw in zip(paths, masters)}
    return {"loss": losses, "grad": grad, "change": change}
