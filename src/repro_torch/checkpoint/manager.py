"""Checkpoints of trees of tensors on dynamically provisioned storage.

The port of ``src/repro/checkpoint/manager.py`` with the same on-disk layout:
one ``.npy`` per leaf named by its ``/``-joined key path (dots in the file
name), ``manifest.json``, then a ``COMMIT`` marker (two-phase commit), and
keep-k GC; then the drain of a committed step to the global FS (the paper's
stage-out), in the background or not. A tree is nested dicts, NamedTuples
(a train state: ``OptState`` keys its leaves by field name, as JAX's
``GetAttrKey`` does) and tuples (keyed by index).

numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as its
raw 16-bit words (a uint16 ``.npy``) and the manifest records ``"bfloat16"``,
the name ``str(arr.dtype)`` gives on the JAX side. ``repro`` saves a bf16
leaf as an ``ml_dtypes`` array, which ``np.load`` reads back without
``ml_dtypes`` as 2-byte voids (descr ``'<V2'``); either way a leaf whose
manifest says ``"bfloat16"`` is taken as its raw 16-bit words, so the port
restores ``repro``'s checkpoints, and ``repro`` restores the port's float32
ones (its own restore takes no bf16 leaf).
"""

from __future__ import annotations

import io
import json
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.client import FSClient
from ..core.datamanager import DataManager, FSError
from ..core.staging import stage


def _children(tree) -> Optional[list[tuple[str, Any]]]:
    """(key, child) pairs in JAX's flattening order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, tuple):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Leaves of a tree in JAX's order, with their ``/``-joined key paths."""
    kids = _children(tree)
    if kids is None:
        return [(prefix.rstrip("/"), tree)]
    return [x for k, c in kids for x in _flatten_with_paths(c, f"{prefix}{k}/")]


def _unflatten_like(tree_like, leaves: dict[str, Any], prefix: str = ""):
    kids = _children(tree_like)
    if kids is None:
        return leaves[prefix.rstrip("/")]
    out = {k: _unflatten_like(c, leaves, f"{prefix}{k}/") for k, c in kids}
    if isinstance(tree_like, dict):
        return {k: out[str(k)] for k in tree_like}
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(**out)
    return type(tree_like)(out[str(i)] for i in range(len(tree_like)))


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":             # the port's uint16 or repro's '<V2' words
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(
        self,
        burst: DataManager,
        root: str = "/ckpt",
        *,
        global_fs: Optional[DataManager] = None,
        global_root: str = "/persist/ckpt",
        keep: int = 3,
    ):
        self.burst = burst
        self.client = FSClient(burst, "ckpt")
        self.root = root.rstrip("/")
        self.global_fs = global_fs
        self.global_root = global_root.rstrip("/")
        self.keep = keep
        self._drains: list[threading.Thread] = []
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

    # -- drain (stage-out to the global FS) -------------------------------
    def drain_async(self, step: int) -> threading.Thread:
        """Start the drain off the training path; join() the returned thread
        (or call wait_drains) before tearing the burst tier down."""
        t = threading.Thread(target=self.drain_to_global, args=(step,),
                             name=f"ckpt-drain-{step}", daemon=True)
        self._drains.append(t)
        t.start()
        return t

    def wait_drains(self) -> None:
        for t in self._drains:
            t.join()
        self._drains.clear()

    def drain_to_global(self, step: int) -> dict:
        """Copy a committed step to the global FS, then commit it there."""
        if self.global_fs is None:
            raise FSError("no global FS configured")
        d = self._step_dir(step)
        names = self.client.readdir(d)
        dst = f"{self.global_root}/step-{step:08d}"
        pairs = [(f"{d}/{n}", f"{dst}/{n}") for n in names if n != "COMMIT"]
        rep = stage(self.burst, self.global_fs, pairs, direction="out")
        FSClient(self.global_fs, "ckpt-drain").write_file(f"{dst}/COMMIT", b"ok")
        return {"files": rep.files, "bytes": rep.bytes,
                "modeled_time_s": rep.modeled_time_s}
