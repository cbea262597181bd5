"""AdamW with global-norm clipping and weight decay on float32 weights, in
the order the program's optimizer states (``optim/adamw.py``): clip, the
moments, the bias corrections, the decayed update."""

from __future__ import annotations

import torch


@torch.no_grad()
def update(params: list, grads: list, m: list, v: list, step: int, opt: dict) -> None:
    """One step on lists of float32 tensors, in place; ``step`` counts from 1."""
    b1, b2 = opt["b1"], opt["b2"]
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_((1 - b1) * g)
        vi.mul_(b2).add_((1 - b2) * g * g)
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"]) + opt["weight_decay"] * p
        p.sub_(opt["lr"] * upd)
