"""Step functions: train_step / prefill / decode_step, on one device and on
a ``DeviceMesh``.

The port of ``src/repro/runtime/parallel.py``. The one-device makers
(``make_*``) have no ``use_kernels`` switch: the port dispatches on the
tensor's device, and on the card every norm and attention layer runs its
forward and backward kernels.

The mesh makers (``shard_train_step``, ``shard_prefill``,
``shard_decode_step``: ``repro``'s ``jit_*``) lay params, optimizer state,
batches and caches out as DTensors by ``runtime/sharding.py``'s rules and
run the same step under ``mesh_hint(mesh, rt.flags)``: the model's
``hints.constrain`` calls put activations in ``repro``'s layouts, DTensor
propagates the rest (the Megatron pattern falls out of the rules), and the
hand-written kernels run on each rank's local shards (``kernels/sharded.py``).
Plain tensors made inside the step (masks, tables) count as replicated
(``implicit_replication``). The train step is ZeRO-1-ready (``rt.zero1``:
m, v and the master weights also sharded over "data"), with gradient
accumulation and int8 error-feedback compression on DTensor grads. Buffer
donation has no counterpart: AdamW updates its state and the params in
place, and decode writes its cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import optim
from ..hints import constrain, mesh_hint
from ..models.common import Model, tree_map
from ..optim.adamw import leaves
from . import sharding as sh


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    remat: Optional[str] = "full"          # None | "dots" (taken as "full") | "full"
    compress_grads: bool = False           # int8 + error feedback
    zero1: bool = True                     # shard opt state over "data" (mesh steps)
    accum: int = 1                         # gradient-accumulation microbatches
    flags: tuple = ()                      # variant switches (hints.flag, "accbf16")
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
    grads = [_placed_like(g, p) for g, p in zip(torch.autograd.grad(loss, flat), flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        _unflatten_like(params, grads)


def _placed_like(g, p):
    """A DTensor grad in its param's placements: pending sums (the data-
    parallel all-reduce, the row-parallel partial products) are reduced."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, rt: RuntimeConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; batch tensors on the
    params' device. Accumulation splits the leading batch dim into
    ``rt.accum`` microbatches."""
    sched = _schedule(rt)

    def grads_of(params, batch):
        return loss_and_grads(model, params, batch, remat=rt.remat)

    def train_step(state: TrainState, batch):
        if rt.accum > 1:
            # microbatch i is rows [i*B/accum, (i+1)*B/accum), sharded over dp:
            # on a mesh the (small, integer) batch is made whole to cut it
            def split(v):
                v = constrain(v, *(None,) * v.ndim)
                return constrain(v.reshape(rt.accum, v.shape[0] // rt.accum, *v.shape[1:]),
                                 None, "dp")
            micro = {k: split(v) for k, v in batch.items()}
            acc_dt = torch.bfloat16 if "accbf16" in rt.flags else torch.float32
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), state.params)
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


# -- the mesh ------------------------------------------------------------------
def distribute_tree(mesh, tree, specs):
    """Lay a tree of full tensors onto ``mesh`` by a tree of logical specs
    (``distribute_tensor`` per leaf). Every rank must hold the identical full
    tensors, built from the same explicit generator: each keeps its own
    shard of its own copy, and nothing is sent. A DTensor leaf is taken as
    laid out already."""
    if isinstance(tree, DTensor):
        return tree
    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [distribute_tree(mesh, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return distribute_tensor(tree, mesh, sh.placements(mesh, specs), src_data_rank=None)


def train_state_shardings(mesh, state_like: TrainState, rt: RuntimeConfig) -> TrainState:
    ps = sh.param_shardings(mesh, state_like.params)
    os_ = sh.opt_shardings(mesh, state_like.opt, ps, zero1=rt.zero1)
    ef = optim.ErrorFeedback(os_.m) if rt.compress_grads else ()   # residuals shadow m
    return TrainState(ps, os_, ef)


def _on_mesh(mesh, rt: RuntimeConfig, fn: Callable) -> Callable:
    def run(*args):
        with mesh_hint(mesh, rt.flags), implicit_replication():
            return fn(*args)
    return run


def shard_train_step(model: Model, mesh, rt: RuntimeConfig, state_like: TrainState,
                     batch_like: dict):
    """``repro``'s ``jit_train_step``: returns (step, state_shardings,
    batch_shardings). ``step(state, batch) -> (state, metrics)`` takes the
    state laid out by ``distribute_tree(mesh, state, state_shardings)`` and
    a batch of full tensors (the same on every rank) or of DTensors; the
    metrics are DTensors."""
    st_sh = train_state_shardings(mesh, state_like, rt)
    b_sh = sh.batch_shardings(mesh, batch_like)
    raw = _on_mesh(mesh, rt, make_train_step(model, rt))

    def step(state: TrainState, batch):
        return raw(state, distribute_tree(mesh, batch, b_sh))

    return step, st_sh, b_sh


def shard_prefill(model: Model, mesh, rt: RuntimeConfig, S_max: int, params_like,
                  batch_like, cache_like):
    """``repro``'s ``jit_prefill``: returns (prefill, param_shardings,
    batch_shardings, cache_shardings). ``prefill(params, batch) -> (logits,
    cache)`` fills an empty cache laid out by the cache rule (KV sequence
    over "model") in ``cache_like``'s shapes, of which each rank makes only
    its own shards (``shard_cache``), as ``repro``'s makes it inside
    ``jax.jit``. ``cache_like`` may be ``model.init_cache`` on the meta
    device."""
    p_sh = sh.param_shardings(mesh, params_like)
    b_sh = sh.batch_shardings(mesh, batch_like)
    c_sh = sh.cache_shardings(mesh, cache_like)
    fill = cache_fill(model)

    def prefill(params, batch):
        batch = distribute_tree(mesh, batch, b_sh)
        return model.prefill(params, batch, S_max, cache=shard_cache(mesh, cache_like, fill))

    return _on_mesh(mesh, rt, prefill), p_sh, b_sh, c_sh


def cache_fill(model: Model) -> dict:
    """The value of each leaf of ``model.init_cache`` (by path), read from a
    one-row, one-position cache made on the CPU (outside any fake mode):
    every leaf holds one value, 0 for most, -1 for gemma3's ``ring_pos``,
    log 0 for the xLSTM's stabiliser states ``m``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    fill = {}

    def one(path, t):
        fill[path] = t.reshape(-1)[0].item()
    with unset_fake_temporarily():
        sh.map_with_path(one, model.init_cache(1, 1, "cpu"))
    return fill


def shard_cache(mesh, cache_like, fill: dict):
    """``cache_like``'s shapes and dtypes filled with ``fill``'s values
    (``cache_fill``), laid out by the cache rule, each rank making only its
    local shard of each leaf (``torch.distributed.tensor.full`` on the
    mesh's device)."""
    from torch.distributed.tensor import full

    def leaf(path, t):
        spec = sh.cache_spec(mesh, path, tuple(t.shape))
        return full(tuple(t.shape), fill[path], dtype=t.dtype,
                    device_mesh=mesh, placements=sh.placements(mesh, spec))
    return sh.map_with_path(leaf, cache_like)


def shard_decode_step(model: Model, mesh, rt: RuntimeConfig, params_like, cache_like,
                      batch_like):
    """``repro``'s ``jit_decode_step``: returns (decode, param_shardings,
    cache_shardings, batch_shardings). Under the "dp_decode" flag the params
    are replicated (small-model serving: batch sharding only)."""
    if "dp_decode" in rt.flags:
        p_sh = sh.replicated(mesh, params_like)
    else:
        p_sh = sh.param_shardings(mesh, params_like)
    c_sh = sh.cache_shardings(mesh, cache_like)
    b_sh = sh.batch_shardings(mesh, batch_like)
    raw = make_decode_step(model, rt)

    def decode(params, cache, batch):
        return raw(params, cache, distribute_tree(mesh, batch, b_sh))

    return _on_mesh(mesh, rt, decode), p_sh, c_sh, b_sh
