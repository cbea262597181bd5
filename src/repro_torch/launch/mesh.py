"""Mesh construction on ``torch.distributed``: the port of
``src/repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module never
touches a process group. The caller starts the process group first
(``torch.distributed.init_process_group`` with its own address, world size
and rank); these build a ``DeviceMesh`` over its first ranks with ``repro``'s
axis names and shapes, and raise as ``repro`` does when the
world is smaller than the mesh.

``init_fake_world(n)`` starts a fake world of ``n`` ranks in this process
(``repro``'s ``XLA_FLAGS=--xla_force_host_platform_device_count=512``):
this process is rank 0, collectives return at once without moving data,
and meshes over it are built with ``device_type="cpu"``. It is for the
dry-run, on fake tensors. A process group is global to its process, so
dry-runs run in a process of their own.
"""

from __future__ import annotations

import math

import torch


def _mesh(shape: tuple, axes: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {have} (start the process group "
            "with a world of that size before building the mesh)")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_smoke_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small (data, model) mesh: the gloo worlds of the CPU tests, the card."""
    return _mesh((data, model), ("data", "model"), device_type)


def init_fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
