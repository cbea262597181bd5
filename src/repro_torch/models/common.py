"""Shared assembly utilities: stacked-layer init and the per-family API."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


class Model(NamedTuple):
    """Uniform per-family API (closures over a ModelConfig)."""

    cfg: ModelConfig
    init: Callable                    # (generator) -> params
    prefill: Callable                 # (params, batch, S_max) -> (logits, cache)
    decode_step: Callable             # (params, cache, batch) -> (logits, cache)
    init_cache: Callable              # (B, S_max, device) -> cache dict
