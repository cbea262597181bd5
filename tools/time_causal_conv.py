#!/usr/bin/env python3
"""Time the Mamba2 mixer's causal conv, bias and SiLU on the card: the path
the kernels replaced against ``kernels.ops.causal_conv_silu``, in turns.

The replaced path is the mixer's lines before the kernels: the decode
state's conv tail taken from a zero pad of the whole ``xBC`` slice (a clone
of it), then ``F.silu`` of the transposing pad, ``F.conv1d``, the bias add
and the transposing ``.contiguous()``. The new path is the sliced tail and
the kernels. Each is timed at Zamba2-7B's training shape (``xBC`` the
(2, 4096, 7424) bf16 slice of in_proj's (2, 4096, 14704) output; w (4,
7424), b (7424,); x a leaf, so that its gradient is the conv's alone) in
two phases: the forward with autograd recording, as a train step's forward
and recompute run it, and the forward and backward. Per phase and path:
CUDA-event ms a call, the profiler's device ms a call, and the same split by
kernel name with launches a call, so that a step's profile can be read
against it; the paths take turns (old, new, new, old) ``--rounds`` times.
The kernels' own device ms are beside their bytes bounds (forward: x and y;
backward: x, dy and dx; at 3.35 TB/s).

One JSON line a reading, then the card's name and power limit. Run from the
repository root:

    python3 tools/time_causal_conv.py [--rounds 3] [--out FILE.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S, ROW, FIRST, CH, W = 2, 4096, 14704, 7168, 7424, 4
HBM = 3.35e12


def emit(out, obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def inputs(torch, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    wide = torch.randn((B, S, ROW), generator=g, device="cuda").to(torch.bfloat16)
    x = wide[..., FIRST:FIRST + CH].detach().requires_grad_()
    w = (torch.randn((W, CH), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    b = (torch.randn((CH,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    dy = torch.randn((B, S, CH), generator=g, device="cuda").to(torch.bfloat16)
    return x, w.requires_grad_(), b.requires_grad_(), dy


def old_path(x, w, b):
    """The mixer's lines before the kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels.causal_conv import causal_conv_plain
    tail = F.pad(x, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):, :]
    return F.silu(causal_conv_plain(x, w, b)), tail


def new_path(x, w, b):
    from repro_torch.kernels import ops
    from repro_torch.models.mamba2 import conv_tail_of
    return ops.causal_conv_silu(x, w, b), conv_tail_of(x, W)


def phases(torch, path, x, w, b, dy):
    def fwd():
        return path(x, w, b)

    def fwd_bwd():
        out, _ = path(x, w, b)
        return torch.autograd.grad(out, (x, w, b), dy)
    return {"forward": fwd, "forward+backward": fwd_bwd}


def event_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def split_ms(torch, fn, iters: int):
    """Mean device ms of one ``fn()`` and {kernel name: [ms, launches]} a call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    if not by_name:
        return None, {}
    split = {k[:140]: [ms / iters, n / iters]
             for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])}
    return sum(v[0] for v in split.values()), split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_causal_conv: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    resolve_device("cuda")
    out = open(args.out, "w") if args.out else None
    try:
        x, w, b, dy = inputs(torch)
        paths = {"old": phases(torch, old_path, x, w, b, dy),
                 "new": phases(torch, new_path, x, w, b, dy)}
        n = B * S * CH
        bound = {"forward": 4 * n / HBM * 1e3, "forward+backward": 10 * n / HBM * 1e3}
        for r in range(args.rounds):
            for name in ("old", "new", "new", "old"):
                for phase, fn in paths[name].items():
                    ops.reset_launches()
                    ms = event_ms(torch, fn, args.iters)
                    dev, split = split_ms(torch, fn, args.iters)
                    emit(out, {"round": r, "path": name, "phase": phase, "ms": ms,
                               "device_ms": dev, "bound_ms": bound[phase],
                               "kernels": split if name == "new" or r == 0 else None})
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        emit(out, {"card": smi, "torch": torch.__version__})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
