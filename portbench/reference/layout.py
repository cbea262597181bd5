"""Parameter layouts: nested dicts whose leaves say a tensor's shape, dtype
and initialisation. The benchmark makes the weights from a layout
(``portbench/weights.py``) and hands the same to the program and to the
reference; the layouts follow the program's parameter trees key for key."""

from __future__ import annotations

from typing import NamedTuple


class Leaf(NamedTuple):
    shape: tuple
    init: str = "normal"        # normal (times fan_in^-1/2), ones, zeros, dt_bias, a_log
    fan_in: int = 1
    dtype: str = "model"        # the configuration's dtype, or "float32"


def dense_w(d_in: int, d_out: int, lead: tuple = ()) -> dict:
    return {"w": Leaf((*lead, d_in, d_out), "normal", d_in)}


def norm_scale(d: int, lead: tuple = ()) -> dict:
    return {"scale": Leaf((*lead, d), "ones")}


def flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in sorted-key order, paths joined by "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def unflatten(pairs) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return out


def index(tree, *i):
    """Each leaf of a stacked tree at leading index ``i``."""
    if isinstance(tree, dict):
        return {k: index(v, *i) for k, v in tree.items()}
    return tree[i]
