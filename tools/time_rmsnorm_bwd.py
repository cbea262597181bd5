#!/usr/bin/env python3
"""Time the launch variants of the port's rmsnorm backward on the card, each
held to its plain version first.

For each shape (bf16 x, g and scale; the forward kernel's inv) and each
variant of ``kernels.rmsnorm.bwd_plan`` (1, 2 or 4 programs an SM, each
writing a row of column partials for the 32-column sum pass; the parent's
launch, four programs an SM and a 128-column sum pass), the device time of the kernels one call launches, split by
kernel name (torch.profiler), and the time by CUDA events, with inputs and
outputs rotated over copies as ``chip_smoke.py`` does; beside them autograd
through ``F.rms_norm`` and the bytes bound (x, g, dx, inv, scale and dscale
once, at 3.35 TB/s). The variants take turns in one process (A, B, ..., then
the same in reverse). Prints one JSON line per shape and variant, then the
card's name and power limit. Run from the repository root:

    python3 tools/time_rmsnorm_bwd.py [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# granite and phi4 training; gemma3's layer norms, q-norm (B 4, S 2048, H 16)
# and k-norm (K 8); zamba2's
SHAPES = [(8192, 1024), (8192, 3072), (8192, 3840), (131072, 256), (65536, 256), (8192, 3584)]


def variants(rows: int, d: int, n_sm: int) -> dict:
    from repro_torch.kernels.rmsnorm import bwd_plan
    base = bwd_plan(rows, d, n_sm)
    out = {"plan": base}
    cap = -(-rows // base["BLOCK_R"])
    for mult in (1, 4):
        out[f"nprog {mult}xSM"] = {**base, "nprog": max(1, min(cap, mult * n_sm))}
    out["parent"] = {**base, "nprog": max(1, min(cap, 4 * n_sm)), "colsum_block": 128}
    return out


def split_ms(torch, fn, iters: int) -> tuple[float | None, dict]:
    """Mean device ms of one ``fn()`` and the same split by kernel name."""
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
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    if not by_name:
        return None, {}
    return sum(by_name.values()) / iters / 1e3, {k: v / iters / 1e3 for k, v in by_name.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_bwd_triton, rmsnorm_triton
    F = torch.nn.functional
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, d in SHAPES:
        nbytes = 3 * rows * d * 2 + 4 * rows + 2 * d * 2
        bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3

        def make(seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            a = {k: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                 for k, shape in (("x", (rows, d)), ("scale", (d,)), ("g", (rows, d)))}
            _, a["inv"] = rmsnorm_triton(a["x"], a["scale"], return_inv=True)
            a["lx"] = a["x"].detach().requires_grad_()
            a["ls"] = a["scale"].detach().requires_grad_()
            a["lout"] = F.rms_norm(a["lx"], (d,), a["ls"], 1e-5)
            return a
        sets = [make(i) for i in range(chip_smoke.copies_for(nbytes))]
        want = rmsnorm_bwd_plain(sets[0]["x"], sets[0]["scale"], sets[0]["g"])
        fns = {name: (lambda a, p=plan: rmsnorm_bwd_triton(a["x"], a["scale"], a["g"], a["inv"],
                                                           plan=p))
               for name, plan in variants(rows, d, n_sm).items()}
        fns["autograd F.rms_norm"] = lambda a: torch.autograd.grad(
            a["lout"], (a["lx"], a["ls"]), a["g"], retain_graph=True)
        results = {name: {"device_ms": [], "ms": []} for name in fns}
        errs = {}
        for name, fn in fns.items():
            got = fn(sets[0])
            torch.cuda.synchronize()
            errs[name] = chip_smoke.compare_grads(torch, got, want, chip_smoke.GRAD_TOL["bfloat16"])
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                rot = chip_smoke.rotating(sets)
                dev_ms, split = split_ms(torch, lambda: rot(fns[name]), args.iters)
                results[name]["device_ms"].append(dev_ms)
                results[name]["split"] = split
                results[name]["ms"].append(chip_smoke.time_ms(torch, lambda: rot(fns[name]),
                                                              iters=args.iters))
        plans = variants(rows, d, n_sm)
        for name in order:
            dms = [x for x in results[name]["device_ms"] if x is not None]
            best = min(dms) if dms else None
            split = {k[:60]: v for k, v in (results[name].get("split") or {}).items()}
            print(json.dumps({"shape": [rows, d], "variant": name,
                              "plan": plans.get(name), "grad_err_of_max": errs[name][0],
                              "ok": errs[name][1], "device_ms": results[name]["device_ms"],
                              "ms": results[name]["ms"], "split_ms": split,
                              "bound_ms": bound_ms,
                              "bound_share": None if best is None else bound_ms / best}),
                  flush=True)
        del sets, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
