"""Stage-in / stage-out between the global FS and a provisioned EphemeralFS.

Paper §V: "a stage in and stage out of data might be required for the
scientific application to run or to retrieve its results". In the training
framework this is how datasets reach the burst tier before step 0 and how
checkpoints drain back to the global store (see ``repro.checkpoint``).
"""

from __future__ import annotations

import dataclasses

from .client import FSClient
from .datamanager import DataManager, FSError
from .perfmodel import FSDeployment, Workload, predict_read, predict_write

_CHUNK = 8 << 20  # 8 MiB copy granularity


@dataclasses.dataclass(frozen=True)
class StageReport:
    files: int
    bytes: int
    modeled_time_s: float      # max(src read, dst write) + per-file overhead
    direction: str             # "in" | "out"


def _copy_file(src: DataManager, dst: DataManager, src_path: str, dst_path: str) -> int:
    st = src.stat(src_path)
    if st.is_dir:
        raise FSError(f"not a file: {src_path}")
    if not dst.exists(dst_path):
        dst.create(dst_path)
    moved = 0
    while moved < st.size:
        take = min(_CHUNK, st.size - moved)
        dst.write(dst_path, moved, src.read(src_path, moved, take))
        moved += take
    return moved


def modeled_stage_time(
    nbytes: float,
    src_model: FSDeployment | None,
    dst_model: FSDeployment | None,
    n_streams: int = 8,
) -> float:
    """Modeled wall time to move ``nbytes`` from ``src`` to ``dst``: the
    slower of the source read and destination write paths at paper scale.
    Shared with the workflow orchestrator, which advances its virtual clock
    by this prediction for every stage-in/stage-out phase (and by the pool
    subsystem, which charges only the *missing* dataset bytes on a cache hit).

    Zero (or negative) byte counts are a no-op — an empty stage must not pay
    the perfmodel's fixed setup ramp — and ``n_streams`` is clamped to >= 1.
    """
    if nbytes <= 0:
        return 0.0
    w = Workload(n_procs=max(1, n_streams), size_per_proc=nbytes / max(1, n_streams),
                 pattern="fpp")
    t = 0.0
    if src_model is not None:
        t = max(t, predict_read(w, src_model).elapsed_s)
    if dst_model is not None:
        t = max(t, predict_write(w, dst_model).elapsed_s)
    return t


def stage(
    src: DataManager,
    dst: DataManager,
    paths: list[tuple[str, str]],
    *,
    src_model: FSDeployment | None = None,
    dst_model: FSDeployment | None = None,
    n_streams: int = 8,
    direction: str = "in",
) -> StageReport:
    """Copy ``[(src_path, dst_path), ...]``; returns bytes + modeled time."""
    total = 0
    for sp, dp in paths:
        parent = dp.rsplit("/", 1)[0]
        if parent and parent != "":
            FSClient(dst, "stager").makedirs(parent)
        total += _copy_file(src, dst, sp, dp)
    t = modeled_stage_time(total, src_model, dst_model, n_streams)
    return StageReport(files=len(paths), bytes=total, modeled_time_s=t, direction=direction)


def stage_tree(
    src: DataManager,
    dst: DataManager,
    src_dir: str,
    dst_dir: str,
    **kw,
) -> StageReport:
    """Recursively stage a directory."""
    pairs: list[tuple[str, str]] = []

    def walk(d: str) -> None:
        for name in src.readdir(d):
            p = f"{d.rstrip('/')}/{name}"
            if src.stat(p).is_dir:
                walk(p)
            else:
                rel = p[len(src_dir):].lstrip("/")
                pairs.append((p, f"{dst_dir.rstrip('/')}/{rel}"))

    walk(src_dir)
    return stage(src, dst, pairs, **kw)
