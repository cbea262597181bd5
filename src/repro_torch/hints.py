"""Mesh hints: lets model code place sharding constraints on activations
without depending on the runtime layer (no-op when no mesh hint is set).

The port of ``src/repro/hints.py``. There the constraint keeps GSPMD from
splitting the head dim after a (B, S, K*hd) -> (B, S, K, hd) reshape; here
the activations are DTensors and ``constrain`` redistributes them to the
head-aligned layout (heads sharded over "model" where the count divides,
replicated otherwise), so that the hand-written kernels see whole heads on
every rank (``kernels/ops.py`` runs them on local shards). On a plain
tensor, or without a hint, it returns ``x`` unchanged.
"""

from __future__ import annotations

import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_hint", default=None)
_FLAGS: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "repro_torch_flags", default=frozenset()
)


def set_mesh_hint(mesh):
    return _MESH.set(mesh)


def get_mesh_hint():
    return _MESH.get()


def flag(name: str) -> bool:
    """Variant switches (``RuntimeConfig.flags``: "moe2d", "bf16bwd",
    "dp_decode", "accbf16")."""
    return name in _FLAGS.get()


class mesh_hint:
    def __init__(self, mesh, flags: tuple = ()):
        self.mesh = mesh
        self.flags = frozenset(flags)

    def __enter__(self):
        self._tok = _MESH.set(self.mesh)
        self._ftok = _FLAGS.set(self.flags)
        return self.mesh

    def __exit__(self, *exc):
        _MESH.reset(self._tok)
        _FLAGS.reset(self._ftok)
        return False


def hint_spec(mesh, shape, logical) -> tuple:
    """The logical spec ``constrain`` asks for: entries None, "dp" or an
    axis name; axes missing from the mesh are dropped, and each entry takes
    its largest prefix that divides the dim."""
    from .runtime.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    spec = []
    for dim, ax in zip(shape, logical):
        if ax is None:
            spec.append(None)
            continue
        if ax == "dp":
            cand = tuple(a for a in sizes if a in ("pod", "data"))
        else:
            cand = (ax,) if ax in sizes else ()
        chosen = None
        for end in range(len(cand), 0, -1):
            sub = cand[:end]
            size = 1
            for a in sub:
                size *= sizes[a]
            if dim % size == 0:
                chosen = sub if len(sub) > 1 else sub[0]
                break
        spec.append(chosen)
    return tuple(spec)


def constrain(x, *logical):
    """Redistribute DTensor ``x`` to the layout ``logical`` names under the
    mesh hint (``hint_spec``); a plain tensor, or no hint: ``x`` as is."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from .runtime.sharding import placements

    want = placements(mesh, hint_spec(mesh, x.shape, logical))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)

