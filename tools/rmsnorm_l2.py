#!/usr/bin/env python3
"""How much of the port's rmsnorm kernel time the card's 50 MB L2 hides, at
the shapes where ``chip_smoke.py`` times it: whether a timed call finds its
input, or the block its output is written to, in L2 from an earlier call.

For each shape (bf16) the device time of the Triton kernel (torch.profiler,
the kernel's own events) is taken five ways, in one process:

  hot          one input, every call: input and output stay in L2
  inputs       ``chip_smoke.copies_for`` input copies in turn, each call's
               output freed at once, so the allocator hands the next call the
               same block (how ``chip_smoke.py`` timed before it kept outputs)
  outputs      one input, each output kept as long as ``rotating`` keeps it
  both         input copies in turn and outputs kept (``chip_smoke.rotating``)
  flushed      a 256 MB buffer written before each call, so neither input nor
               output block is in L2; only the kernel's events are summed

beside the bytes bound (input and output once, at 3.35 TB/s) and, for
``F.rms_norm``, the same five. Prints one JSON line per shape and function,
then the card's name and power limit. Run from the repository root:

    python3 tools/rmsnorm_l2.py [--iters 20]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = [(8192, 1024), (4096, 2048), (4096, 5120), (8192, 3072)]
FLUSH_BYTES = 256 << 20


def kernel_ms(torch, fn, before, keep, iters: int) -> float:
    """Mean device ms of the kernels ``fn()`` launches, ``before()`` run
    ahead of each call and left out of the sum."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        before()
        keep(fn())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            before()
            keep(fn())
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        before()
        torch.cuda.synchronize()
    skip = {e.name for e in alone.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in skip]
    return sum(spans) / iters / 1e3 if spans else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_l2: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import rmsnorm_triton
    F = torch.nn.functional
    dev = torch.device("cuda")
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    fns = {"rmsnorm_triton": lambda x, s: rmsnorm_triton(x, s),
           "F.rms_norm": lambda x, s: F.rms_norm(x, (x.shape[-1],), s, 1e-5)}
    for shape in SHAPES:
        g = torch.Generator(device=dev).manual_seed(3)
        nbytes = 2 * shape[0] * shape[1] * 2 + shape[1] * 2
        n_copies = cs.copies_for(nbytes)
        xs = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(n_copies)]
        scale = torch.randn(shape[-1:], generator=g, device=dev).to(torch.bfloat16)
        for name, f in fns.items():
            turn = {"i": 0}

            def next_x():
                turn["i"] += 1
                return xs[turn["i"] % n_copies]

            def drop(out):
                return None

            def kept():
                return collections.deque(maxlen=n_copies).append

            def nothing():
                return None

            def flush():
                flush_buf.zero_()
            row = {"shape": list(shape), "function": name, "dtype": "bfloat16",
                   "copies": n_copies, "bytes": nbytes,
                   "bound_bytes_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   "hot": kernel_ms(torch, lambda: f(xs[0], scale), nothing, drop, args.iters),
                   "inputs": kernel_ms(torch, lambda: f(next_x(), scale), nothing, drop,
                                       args.iters),
                   "outputs": kernel_ms(torch, lambda: f(xs[0], scale), nothing, kept(),
                                        args.iters),
                   "both": kernel_ms(torch, lambda: f(next_x(), scale), nothing, kept(),
                                     args.iters),
                   "flushed": kernel_ms(torch, lambda: f(next_x(), scale), flush, kept(),
                                        args.iters)}
            print(json.dumps(row), flush=True)
        del xs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
