"""What the traced run reads: the device's kernels from the profiler, the
calls into the port's kernels with their shapes, and the harness's own host
spans; and what the per-layer metrics' readers are given (``Window``).

The busy union and the matmul pattern are frozen copies of the program's
``launch/profile.py``; each port kernel's pattern is in its own file under
``kernels/``."""

from __future__ import annotations

import functools
import importlib
import pkgutil
import re
from pathlib import Path

from . import kernels as kernel_pkg
from . import peaks

MATMUL = re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas", re.I)
MEMORY = re.compile(r"^Mem(cpy|set)")


def kernel_modules() -> dict:
    """{name: module} of every file under ``kernels/``."""
    path = Path(kernel_pkg.__file__).parent
    return {m.name: importlib.import_module(f"{kernel_pkg.__name__}.{m.name}")
            for m in pkgutil.iter_modules([str(path)])}


class Taps:
    """Records each call into the port's kernels while it is entered: the
    entry each kernel file names is wrapped in its module, and the call's
    bound (``peaks.bound_ms`` of its ``work``) added up."""

    def __init__(self, modules: dict):
        self.modules = modules
        self.calls = {name: {"calls": 0, "bound_ms": 0.0, "bytes_ms": 0.0, "operations_ms": 0.0}
                      for name in modules}
        self._saved = []

    def _wrap(self, name, fn):
        work, rec = self.modules[name].work, self.calls[name]

        @functools.wraps(fn)
        def tapped(*args, **kwargs):
            ms, by = peaks.bound_ms(*work(*args, **kwargs))
            rec["calls"] += 1
            rec["bound_ms"] += ms
            rec[f"{by}_ms"] += ms
            return fn(*args, **kwargs)
        return tapped

    def __enter__(self):
        for name, mod in self.modules.items():
            where, attr = mod.TAP
            owner = importlib.import_module(where)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def device_events(prof) -> list:
    """(name, start_us, end_us) of every device activity in the trace, read
    from the profiler's raw results (building its event tree would take
    minutes at a window's hundreds of thousands of kernels)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def category(name: str, patterns: dict) -> str:
    """A port kernel's name, "matmul", "memory", or "torch_op"."""
    for kernel, pat in patterns.items():
        if pat.search(name):
            return kernel
    if MATMUL.search(name):
        return "matmul"
    if MEMORY.search(name):
        return "memory"
    return "torch_op"


class Window:
    """One traced window, as the per-layer readers see it."""

    def __init__(self, *, steps: int, window_s: float, model_flops_per_step: float,
                 loader_s: list, events: list, taps: dict, modules: dict, host_spans: list,
                 first_copy_ns: int | None):
        self.steps = steps
        self.window_s = window_s
        self.model_flops_per_step = model_flops_per_step
        self.loader_s = loader_s
        self.taps = taps
        self.events = events
        patterns = {k: re.compile(m.PATTERN) for k, m in modules.items()}
        self.device_s: dict = {}
        self.by_name: dict = {}
        for name, s, e in events:
            cat = category(name, patterns)
            self.device_s[cat] = self.device_s.get(cat, 0.0) + (e - s) / 1e6
            self.by_name[name] = self.by_name.get(name, 0.0) + (e - s) / 1e6
        self.busy_s = busy_us([(s, e) for _, s, e in events]) / 1e6
        self._host_spans = host_spans
        self._first_copy_ns = first_copy_ns

    def roofline(self, kernel: str):
        """Σ bound / device time of ``kernel`` in the window, in %, and what
        bounds it; None where it did not run."""
        rec, secs = self.taps.get(kernel), self.device_s.get(kernel, 0.0)
        if not rec or not rec["calls"] or secs <= 0:
            return None
        by = "bytes" if rec["bytes_ms"] >= rec["operations_ms"] else "operations"
        return {"value": 100.0 * rec["bound_ms"] / 1e3 / secs, "by": by,
                "calls": rec["calls"]}

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": self.idle_gaps(top)}

    def idle_gaps(self, top: int) -> list:
        """The longest gaps between device activity, each named by what the
        harness's host loop was doing then (its spans, placed on the device's
        clock by the window's first host-to-device copy, which the idle
        device starts at once)."""
        spans = sorted((s, e) for _, s, e in self.events)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        copies = [s for n, s, _ in self.events if MEMORY.search(n) and "HtoD" in n]
        out = []
        for a, b in gaps[:top]:
            label = "host: unlabelled"
            if copies and self._first_copy_ns is not None:
                mid_ns = self._first_copy_ns + ((a + b) / 2 - min(copies)) * 1e3
                label = next((f"host: {what}" for what, s0, s1 in self._host_spans
                              if s0 <= mid_ns < s1), "host: between the harness's spans")
            out.append([label, (b - a) / 1e6])
        return out
