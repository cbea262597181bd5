"""AdamW with fp32 master weights, global-norm clipping and mixed-precision
params: the port of ``src/repro/optim/adamw.py``, with its arithmetic and
order (``torch.optim.AdamW`` clips and updates in another order).

Unlike the JAX version, ``update`` updates m, v and the master weights IN
PLACE and writes the new params into the params' own tensors: at phi4-mini's
width a second copy of the fp32 state is ~24 GB. The returned state holds
the same dicts and a new step. It works one leaf at a time, so its
temporaries are the size of the largest leaf; ``torch._foreach_*`` ops would
hold one temporary per leaf at once (~8 GB each at that width).

Each leaf goes through ``kernels.ops``: on the card one fused update
(``adamw``) and one sum-of-squares launch for the clip (``grad_sumsq``), the
clip scale, lr and bias corrections handed over in a float32 (4,) tensor on
the device, so nothing is read back to the host; CPU tensors and DTensors
(the mesh steps of ``runtime/parallel.py``) run the plain versions, this
loop's arithmetic, the norm then the whole tensor's on every rank. Under
ZeRO-1 (m, v and the master weights also sharded over "data") each grad is
cut to the state's layout before the update, and copying the new master
weights into the param gathers them to the param's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..models.common import tree_map
from ..spans import span


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # 0-dim int32
    master: Any                 # fp32 params
    m: Any
    v: Any


def leaves(tree) -> list:
    """The leaves of nested dicts in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def init(params) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in float32."""
    return torch.sqrt(ops.grad_sumsq([g.detach().contiguous() for g in leaves(tree)]))


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 scalar tensor on ``device``, made there (a Python
    number copied from the host would synchronise)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _to(t, like):
    """DTensor ``t`` in ``like``'s placements (a local slice where ``like``
    adds a shard, a gather where it drops one); a plain tensor as it is."""
    if isinstance(t, DTensor) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, stats). ``lr_scale`` multiplies cfg.lr
    (schedules pass the factor)."""
    step = state.step + 1
    grads = [g.contiguous() for g in leaves(grads)]
    with span("optim.clip"):
        gnorm = torch.sqrt(ops.grad_sumsq(grads))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, stepf.device), stepf)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, stepf.device), stepf)
    lr = cfg.lr * _f32(lr_scale, stepf.device)
    hyper = torch.stack((scale, lr, bc1, bc2))
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    for g, m, v, mw, p in zip(grads, leaves(state.m), leaves(state.v), leaves(state.master),
                              leaves(params)):
        ops.adamw(_to(g, m), m, v, mw, p, hyper, **kw)
    return params, OptState(step, state.master, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
