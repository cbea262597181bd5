"""Shared assembly utilities: stacked-layer init, remat, the per-family API."""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..hints import get_mesh_hint
from ..spans import spanned


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every tensor leaf of nested dicts (and the matching
    leaves of ``rest``, dicts of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unstack(tree, n: int) -> list:
    """Stacked params (leading dim ``n``) -> ``n`` per-layer trees of views,
    from one ``unbind`` a leaf (whose backward stacks the per-layer grads
    once, where indexing each layer would scatter into a zero stack)."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


def stack_init(gen: torch.Generator, n: int, fn: Callable):
    """``fn(gen) -> params`` called ``n`` times -> params stacked on a leading
    dim of ``n`` (the JAX version vmaps over ``n`` keys). Each layer is written
    into the preallocated stack, so init never holds two copies."""
    first = fn(gen)
    stacked = tree_map(lambda a: a.new_empty((n, *a.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(stacked, first, 0)
    del first
    for i in range(1, n):
        put(stacked, fn(gen), i)
    return stacked


def serving(fn: Callable) -> Callable:
    """``inference_mode`` for a serve entry point; ``no_grad`` under a mesh
    hint, since DTensor views cannot be made of non-inference tensors in
    inference mode. Either way no gradient is kept and the same kernels run."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad() if get_mesh_hint() is not None else torch.inference_mode():
            return fn(*args, **kwargs)
    return run


def remat_wrap(fn: Callable, policy: Optional[str]) -> Callable:
    """``repro``'s remat policies on ``torch.utils.checkpoint`` (non-reentrant):
    ``None``/``"none"`` keeps every activation; ``"full"`` keeps only the
    wrapped function's inputs and recomputes the rest in the backward.
    ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``, which keeps the
    matmul outputs) has no torch twin and is taken as ``"full"``. Each call of
    the layer, and under remat each recompute, runs in a ``model.layer`` span."""
    fn = spanned("model.layer")(fn)
    if policy is None or policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)


class Model(NamedTuple):
    """Uniform per-family API (closures over a ModelConfig)."""

    cfg: ModelConfig
    init: Callable                    # (generator) -> params
    loss: Callable                    # (params, batch, *, remat) -> (loss, metrics)
    prefill: Callable                 # (params, batch, S_max) -> (logits, cache)
    decode_step: Callable             # (params, cache, batch) -> (logits, cache)
    init_cache: Callable              # (B, S_max, device) -> cache dict
