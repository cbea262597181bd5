"""Sharding rules: tree paths -> logical specs for the (pod, data, model)
mesh, and logical specs -> DTensor placements.

The port of ``src/repro/runtime/sharding.py``. Tensor parallelism rides the
"model" axis (attention/FFN inner dims, vocab, MoE experts, SSM inner
channels); data parallelism rides ("pod", "data"). Rules are *candidate
lists*: the first assignment whose axis sizes divide the dimension wins,
axes that do not divide are dropped (e.g. internvl2's odd 92553 vocab falls
back from vocab- to d_model-sharding). Stacked-layer leading dims are padded
with None automatically.

A **logical spec** is a tuple with one entry per tensor dim (or ``()`` for
replicated): None, an axis name, or a tuple of axis names -- the entries of
``repro``'s ``PartitionSpec``. The rules read only a mesh's axis names and
sizes (``axis_sizes``), so they take a ``DeviceMesh`` or any shape-only
stand-in with ``shape`` (a dict) and ``axis_names``. ``placements`` turns a
logical spec into DTensor placements on a ``DeviceMesh``; the
``*_shardings`` functions return trees of logical specs shaped like the
trees they are given.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

MODEL = "model"


def axis_sizes(mesh) -> dict:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _sanitize(mesh, spec: Sequence, shape: tuple[int, ...]) -> tuple:
    """Drop axis assignments that don't divide the dim; composite dp axes
    degrade to their largest dividing prefix."""
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(None)
            continue
        cand = axes if isinstance(axes, tuple) else (axes,)
        # try full composite, then prefixes, then single axes
        chosen = None
        options = [cand] + [cand[:i] for i in range(len(cand) - 1, 0, -1)] + [
            (a,) for a in cand
        ]
        for opt in options:
            if dim % _axis_size(mesh, opt) == 0:
                chosen = opt if len(opt) > 1 else opt[0]
                break
        out.append(chosen)
    # an axis may appear at most once in the spec
    seen = set()
    final = []
    for axes in out:
        cand = _axes(axes)
        if any(a in seen for a in cand):
            final.append(None)
            continue
        seen.update(cand)
        final.append(axes)
    return tuple(final)


# -- parameter rules ----------------------------------------------------------
# (substring match on the '/'-joined path, logical spec for the trailing dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    ("router/w", (None, None)),
    ("moe/gate", (MODEL, None, None)),       # (E, d, f): expert parallel
    ("moe/up", (MODEL, None, None)),
    ("moe/down", (MODEL, None, None)),
    ("embed/w", (MODEL, None)),
    ("unembed/w", (MODEL, None)),
    ("wq/w", (None, MODEL)),
    ("wk/w", (None, MODEL)),
    ("wv/w", (None, MODEL)),
    ("wq/b", (MODEL,)),
    ("wk/b", (MODEL,)),
    ("wv/b", (MODEL,)),
    ("wo/w", (MODEL, None)),
    ("gate/w", (None, MODEL)),
    ("up/w", (None, MODEL)),
    ("down/w", (MODEL, None)),
    ("in_proj/w", (None, MODEL)),
    ("out_proj/w", (MODEL, None)),
    ("conv_w", (None, MODEL)),
    ("conv_b", (MODEL,)),
    ("gnorm/scale", (MODEL,)),
    ("w_in/w", (None, MODEL)),
    ("w_in/b", (MODEL,)),
    ("w_gates/w", (None, MODEL)),
    ("w_gates/b", (MODEL,)),
    ("skip", (MODEL,)),
    ("R", (None, MODEL, None, None)),        # (4, H, dh, dh)
]

# how many leading stacked-layer dims each top-level group carries
_STACK_DIMS = {
    "layers": 1,
    "local_layers": 2,
    "global_layers": 1,
    "mamba_groups": 2,
    "mamba_tail": 1,
    "shared": 0,
    "slstm": 1,
    "mlstm": 2,
    "enc_layers": 1,
    "dec_layers": 1,
}


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts, tuples and lists; ``path`` is
    the '/'-joined keys and indices, as ``repro``'s ``_path_str`` gives."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        return type(tree)(map_with_path(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(mesh, path_str: str, shape: tuple[int, ...]) -> tuple:
    top = path_str.split("/")[0]
    n_stack = _STACK_DIMS.get(top, 0)
    logical_shape = shape[n_stack:]
    for pat, spec in _PARAM_RULES:
        if pat in path_str and len(spec) == len(logical_shape):
            full = (None,) * n_stack + tuple(spec)
            return _sanitize(mesh, full, shape)
    return ()  # replicate (norm scales, small vectors, ...)


def param_shardings(mesh, params_like):
    return map_with_path(lambda path, leaf: param_spec(mesh, path, tuple(leaf.shape)),
                         params_like)


# -- optimizer state ----------------------------------------------------------
def zero1_spec(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """``spec`` padded to the rank, plus "data" on the largest free dim that
    it divides (argsort order, ties as numpy breaks them), unless "data" is
    already used."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    sizes = axis_sizes(mesh)
    if "data" in sizes and "data" not in {a for s in spec for a in _axes(s)}:
        for i in np.argsort([-d for d in shape]):
            if spec[i] is None and shape[i] % sizes["data"] == 0:
                spec[i] = "data"
                break
    return tuple(spec)


def opt_shardings(mesh, opt_like, params_sharding, *, zero1: bool = False):
    """m/v/master shadow the param shardings; with zero1, additionally shard
    the largest unsharded dim over "data" (optimizer-state partitioning).
    Returns an ``OptState`` of logical specs."""
    from ..optim.adamw import OptState

    def shadow(ps, leaf):
        shape = tuple(leaf.shape)
        if zero1:
            return zero1_spec(mesh, ps, shape)
        return tuple(ps) + (None,) * (len(shape) - len(ps))

    def tree(ps_tree, leaf_tree):
        if isinstance(leaf_tree, dict):
            return {k: tree(ps_tree[k], leaf_tree[k]) for k in leaf_tree}
        return shadow(ps_tree, leaf_tree)

    return OptState(step=(), master=tree(params_sharding, opt_like.master),
                    m=tree(params_sharding, opt_like.m), v=tree(params_sharding, opt_like.v))


# -- activations / batches / caches ------------------------------------------
def batch_spec(mesh, shape: tuple[int, ...]) -> tuple:
    dp = dp_axes(mesh)
    spec = [None] * len(shape)
    if len(shape) >= 1 and shape[0] % _axis_size(mesh, dp) == 0:
        spec[0] = dp if len(dp) > 1 else dp[0]
    return _sanitize(mesh, spec, shape)


def batch_shardings(mesh, batch_like):
    return map_with_path(lambda path, leaf: batch_spec(mesh, tuple(leaf.shape)), batch_like)


def cache_spec(mesh, name: str, shape: tuple[int, ...]) -> tuple:
    """Decode caches: batch over dp where divisible; KV sequence over
    "model" (flash-decode style context parallelism, head-count agnostic);
    SSM states shard heads over "model"; the mLSTM matrix memory is
    batch-local."""
    dp = dp_axes(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    if ndim == 0:
        return ()
    # mlstm matrix memory (..., B, H, dh, dh): BATCH-LOCAL (dp only); model-
    # axis sharding here made repro's GSPMD replicate the whole cache every
    # step (its sharding.py says why)
    if ndim >= 5 and shape[-1] == shape[-2]:
        spec[-4] = dp
    # KV-style caches: (..., B, S, K, hd)
    elif any(k in name for k in ("k", "v", "sk", "sv", "gk", "gv", "ck", "cv")) \
            and ndim >= 4 and "ring" not in name and "conv" not in name:
        spec[-4] = dp
        spec[-3] = MODEL
    elif "conv" in name:                       # (..., B, W-1, Ch)
        spec[-3] = dp
    elif name.endswith("h") and ndim >= 4:     # ssm state (..., B, H, P, N)
        spec[-4] = dp
        spec[-3] = MODEL
    elif ndim >= 3:                            # n/m/c/h recurrent states
        spec[-3] = dp
    return _sanitize(mesh, spec, shape)


def cache_shardings(mesh, cache_like):
    return map_with_path(lambda path, leaf: cache_spec(mesh, path, tuple(leaf.shape)),
                         cache_like)


def replicated(mesh, tree_like):
    return map_with_path(lambda path, leaf: (), tree_like)


# -- logical spec -> DTensor placements --------------------------------------
def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for a logical spec:
    ``Shard(d)`` on every mesh dim that tensor dim ``d`` names, in mesh
    order (a composite ``("pod", "data")`` shards its dim over both, pod
    major, as JAX does), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate() for a in axis_sizes(mesh))

