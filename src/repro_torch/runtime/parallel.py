"""Step builders on one device: train_step / prefill / decode_step.

The port of ``src/repro/runtime/parallel.py`` without the mesh: no
shardings, no ZeRO-1, no buffer donation (the optimizer updates its state in
place instead, ``optim/adamw.py``), and no ``use_kernels`` switch (the port
dispatches on the tensor's device: on the card every norm and attention
layer runs its forward and backward kernels). Multi-device comes with the
``torch.distributed`` slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import optim
from ..models.common import Model, tree_map
from ..optim.adamw import leaves


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    remat: Optional[str] = "full"          # None | "dots" (taken as "full") | "full"
    compress_grads: bool = False           # int8 + error feedback
    accum: int = 1                         # gradient-accumulation microbatches
    flags: tuple = ()                      # variant switches ("accbf16")
    schedule: str = "warmup_cosine"
    opt: optim.AdamWConfig = dataclasses.field(default_factory=optim.AdamWConfig)


class TrainState(NamedTuple):
    params: Any
    opt: optim.OptState
    ef: Any                                # ErrorFeedback | () when disabled


def make_train_state(model: Model, gen: torch.Generator, rt: RuntimeConfig) -> TrainState:
    params = model.init(gen)
    opt = optim.init(params)
    ef = optim.ef_init(params) if rt.compress_grads else ()
    return TrainState(params, opt, ef)


def _schedule(rt: RuntimeConfig) -> Callable:
    if rt.schedule == "warmup_cosine":
        return optim.warmup_cosine
    return optim.constant


def _unflatten_like(tree, flat: list):
    """Leaves in ``leaves(tree)`` order -> nested dicts shaped like ``tree``."""
    it = iter(flat)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        return next(it)
    return take(tree)


def loss_and_grads(model: Model, params, batch, *, remat: Optional[str] = None):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the grads are
    nested dicts like ``params``, in the params' dtypes."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        _unflatten_like(params, list(grads))


def make_train_step(model: Model, rt: RuntimeConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; batch tensors on the
    params' device. Accumulation splits the leading batch dim into
    ``rt.accum`` microbatches."""
    sched = _schedule(rt)

    def grads_of(params, batch):
        return loss_and_grads(model, params, batch, remat=rt.remat)

    def train_step(state: TrainState, batch):
        if rt.accum > 1:
            micro = {k: v.reshape(rt.accum, v.shape[0] // rt.accum, *v.shape[1:])
                     for k, v in batch.items()}
            acc_dt = torch.bfloat16 if "accbf16" in rt.flags else torch.float32
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
                            state.params)
            loss_sum = 0.0
            for i in range(rt.accum):
                loss, _, g = grads_of(state.params, {k: v[i] for k, v in micro.items()})
                gsum = tree_map(lambda a, gg: a + gg.to(acc_dt), gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / rt.accum, gsum)
            loss = loss_sum / rt.accum
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        else:
            loss, metrics, grads = grads_of(state.params, batch)

        ef = state.ef
        if rt.compress_grads:
            grads, ef, _ = optim.compress_grads(grads, state.ef)
        params, opt, stats = optim.update(
            grads, state.opt, state.params, rt.opt,
            lr_scale=sched(state.opt.step.to(torch.float32)))
        return TrainState(params, opt, ef), {"loss": loss, **metrics, **stats}

    return train_step


# -- serving -----------------------------------------------------------------
def make_prefill(model: Model, S_max: int, rt: RuntimeConfig) -> Callable:
    def prefill(params, batch):
        return model.prefill(params, batch, S_max)

    return prefill


def make_decode_step(model: Model, rt: RuntimeConfig) -> Callable:
    def decode(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return decode
