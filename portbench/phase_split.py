"""The phase split of a training cell's step, and what recording the
program's spans costs, on one CUDA device.

    python3 portbench/phase_split.py --workload phi4-train-s2048 --seed N \\
        --seconds 30 [--pairs 5 --pair-seconds 10] [--out FILE]

Builds the cell as ``kinds/train.py`` does (``Program``) and drives it
through its first steps; then one traced window as the ``--trace 1`` run's,
with the profiler's CUDA activity alone, inside ``repro_torch.spans.record()``:
its phase split (``phases.attribute``), read by the
``*_ms_per_step.train`` phase metrics, beside what ``trace.Window`` reads
from the same window (idle, PyTorch's own kernels apart from the port's by
``kernels/``' patterns, the idle gaps as the harness names them). Then
``--pairs`` pairs of untraced windows of ``--pair-seconds``, spans off and
on in turns (off first in even pairs): tokens/s of each. Prints one JSON
line for each, and writes them to ``--out``. Exits non-zero without a CUDA
device."""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE_METRICS = ("forward_ms_per_step.train", "head_ms_per_step.train",
                 "recompute_ms_per_step.train", "backward_ms_per_step.train",
                 "optimizer_ms_per_step.train", "batch_at_ms_per_step.train")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def window(prog, first: int, seconds: float, sync, traced: bool = False, spans_on: bool = False):
    """Steps from ``first`` for ``seconds``, ended by a synchronise:
    (steps, seconds, recording or None, profiler or None). Traced, the
    profiler records the device's activity (the host's, off a CUDA device,
    so that a CPU rehearsal runs the same path and finds no device work)."""
    import contextlib

    from repro_torch import spans
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(spans.record()) if traced or spans_on else None
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            act = ProfilerActivity.CUDA if prog.device.type == "cuda" else ProfilerActivity.CPU
            prof = stack.enter_context(profile(activities=[act]))
        i, t0 = first, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            prog.step(i)
            i += 1
        sync()
        took = time.perf_counter() - t0
    return i - first, took, rec, prof


def run(cell, seed: int, seconds: float, pairs: int, pair_seconds: float, device) -> list:
    import torch

    from portbench import generate, phases, trace
    from portbench.harness import free_device, load_reader
    from portbench.kinds.train import Program
    tr = cell.traffic
    total = seconds + 2 * pairs * pair_seconds
    tokens = generate.corpus(tr, cell.config["vocab_size"], seed, generate.steps_for(tr, total))
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    kind = torch.cuda.get_device_name(device) if cuda else device.type
    lines = []
    prog = Program(cell, seed, device, tokens)
    try:
        i = tr["check_steps"]
        for k in range(i):
            prog.step(k)
        sync()
        prog.host_spans.clear()
        prog.loader_s.clear()
        prog.first_copy_ns = None
        steps, took, rec, prof = window(prog, i, seconds, sync, traced=True)
        i += steps
        launches, device_acts = phases.profiler_activity(prof)
        w = trace.Window(
            steps=steps, window_s=took,
            model_flops_per_step=cell.family.model_flops(cell.config, tr["batch"], tr["seq"]),
            loader_s=list(prog.loader_s), events=trace.device_events(prof), taps={},
            modules=trace.kernel_modules(), host_spans=list(prog.host_spans),
            first_copy_ns=prog.first_copy_ns)
        del prof
        w.phases = phases.attribute(rec, launches, device_acts, steps, prog.host_spans)
        p = w.phases
        total_ms = 1e3 * p.total_s / steps if steps else 0.0
        parts_ms = 1e3 * (sum(p.device_s.values()) + p.unspanned_s + p.unmatched_s) / steps \
            if steps else 0.0
        lines.append({
            "window": "traced", "cell": cell.name, "seed": seed, "device": kind,
            "steps": steps, "window_s": took,
            "step_ms": 1e3 * took / steps if steps else None,
            "metrics": {m: load_reader(m)(w) for m in PHASE_METRICS},
            "device_ms_per_step": total_ms, "phases_sum_ms_per_step": parts_ms,
            "unspanned_ms_per_step": 1e3 * p.unspanned_s / steps if steps else None,
            "unmatched_ms_per_step": 1e3 * p.unmatched_s / steps if steps else None,
            "matched_share": p.matched_share,
            "launch_events": len(launches), "device_activities": len(device_acts),
            "clip_host_ms_per_step": 1e3 * p.clip_host_s / steps if steps else None,
            "spans_per_step": len(rec.spans) / steps if steps else None,
            "torch_op_ms_per_step.train": load_reader("torch_op_ms_per_step.train")(w),
            "device_idle_share.train": load_reader("device_idle_share.train")(w),
            "idle_gaps": p.idle_gaps, "idle_gaps_by_harness": w.idle_gaps(10),
        })
        print(json.dumps(lines[-1]), flush=True)
        # the trace's hundreds of thousands of Python objects would make each of
        # the cyclic collector's full passes in the pairs stall the loop
        del w, rec, p, launches, device_acts
        gc.collect()
        for k in range(pairs):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                steps, took, _, _ = window(prog, i, pair_seconds, sync, spans_on=on)
                i += steps
                lines.append({"window": "pair", "pair": k, "spans": on, "steps": steps,
                              "window_s": took, "device": kind, "train_tokens_per_s":
                              steps * tr["batch"] * tr["seq"] / took})
                print(json.dumps(lines[-1]), flush=True)
    finally:
        prog.close()
        del prog
        free_device()
    off = [x["train_tokens_per_s"] for x in lines if x["window"] == "pair" and not x["spans"]]
    on = [x["train_tokens_per_s"] for x in lines if x["window"] == "pair" and x["spans"]]
    if off and on:
        ratios = [b / a for a, b in zip(off, on)]
        lines.append({"window": "overhead", "pairs": len(ratios),
                      "off_median": statistics.median(off), "on_median": statistics.median(on),
                      "on_over_off": ratios, "on_over_off_median": statistics.median(ratios)})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--pair-seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench.harness import Cell
    cell = Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("phase_split: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    lines = run(cell, args.seed, args.seconds, args.pairs, args.pair_seconds,
                resolve_device("cuda"))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"phase_split: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
