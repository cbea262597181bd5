"""Checkpoints of nested dicts of tensors on dynamically provisioned storage.

The port of ``src/repro/checkpoint/manager.py`` with the same on-disk layout:
one ``.npy`` per leaf named by its ``/``-joined key path (dots in the file
name), ``manifest.json``, then a ``COMMIT`` marker (two-phase commit), and
keep-k GC. The drain to the global FS comes with the checkpoint slice.

numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as its
raw 16-bit words (a uint16 ``.npy``) and the manifest records ``"bfloat16"``,
the name ``str(arr.dtype)`` gives on the JAX side. Restoring a checkpoint
that ``repro`` wrote is not supported yet.
"""

from __future__ import annotations

import io
import json
from typing import Any, Optional

import numpy as np
import torch

from ..core.client import FSClient
from ..core.datamanager import DataManager, FSError


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Leaves of nested dicts in JAX's order (sorted keys), with their paths."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten_like(tree_like, leaves: dict[str, Any], prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/") for k, v in tree_like.items()}
    return leaves[prefix.rstrip("/")]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(
        self,
        burst: DataManager,
        root: str = "/ckpt",
        *,
        keep: int = 3,
    ):
        self.burst = burst
        self.client = FSClient(burst, "ckpt")
        self.root = root.rstrip("/")
        self.keep = keep
        self.client.makedirs(self.root)

    # -- save -----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return f"{self.root}/step-{step:08d}"

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> dict:
        """Write a sharded checkpoint; returns manifest dict."""
        d = self._step_dir(step)
        self.client.makedirs(d)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        total = 0
        for key, leaf in _flatten_with_paths(tree):
            arr, dtype = _to_numpy(leaf)
            fname = key.replace("/", ".") + ".npy"
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            data = buf.getvalue()
            self.client.write_file(f"{d}/{fname}", data)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype, "bytes": len(data)}
            )
            total += len(data)
        manifest["total_bytes"] = total
        self.client.write_file(f"{d}/manifest.json", json.dumps(manifest).encode())
        # two-phase commit marker
        self.client.write_file(f"{d}/COMMIT", b"ok")
        self._gc()
        return manifest

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            self._rm_tree(self._step_dir(s))

    def _rm_tree(self, d: str) -> None:
        try:
            names = self.client.readdir(d)
        except FSError:
            return
        for n in names:
            p = f"{d}/{n}"
            if self.client.stat(p).is_dir:
                self._rm_tree(p)
            else:
                self.client.unlink(p)
        self.client.rmdir(d)

    # -- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        """Committed steps, ascending."""
        out = []
        for name in self.client.readdir(self.root):
            if not name.startswith("step-"):
                continue
            d = f"{self.root}/{name}"
            if self.client.exists(f"{d}/COMMIT"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def restore(self, tree_like: Any, step: Optional[int] = None) -> tuple[Any, int]:
        """Read a committed step into the structure of ``tree_like``; each
        leaf lands on the device of the matching leaf of ``tree_like``."""
        steps = self.steps()
        if not steps:
            raise FSError("no committed checkpoints")
        step = steps[-1] if step is None else step
        if step not in steps:
            raise FSError(f"step {step} not committed (have {steps})")
        d = self._step_dir(step)
        manifest = json.loads(self.client.read_file(f"{d}/manifest.json"))
        by_key = {m["key"]: m for m in manifest["leaves"]}
        out = {}
        for key, like in _flatten_with_paths(tree_like):
            m = by_key[key]
            raw = self.client.read_file(f"{d}/{m['file']}")
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
            out[key] = _from_numpy(arr, m["dtype"]).to(like.device)
        return _unflatten_like(tree_like, out), step
