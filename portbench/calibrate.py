"""The readings that a cell's limits are set from, at the cell's own size on
one CUDA device (the benchmark's runs never run this):

- the program's first steps against the float32 reference on every seed;
- the control: the reference on fp8 products put in the program's place;
- the faults a training cell can have, planted under the program: half of
  each batch left out ("half_batch") and a step that returns its state
  unchanged ("unchanged").

    python3 portbench/calibrate.py --workload NAME --seeds 11,12,... \
        [--control 3] [--faults 3] [--out FILE]

Prints one JSON line a seed and writes them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds (the first ones) for the control")
    ap.add_argument("--faults", type=int, default=3, help="seeds (the first ones) for each fault")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

    from portbench import check, generate, harness
    from portbench.kinds import train
    from repro_torch.device import resolve_device
    import torch

    dev = resolve_device("cuda")
    cell = harness.Cell.load(args.workload)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], seed,
                                 generate.steps_for(cell.traffic, 0))
        got = {}
        runs = [("program", None)]
        if i < args.faults:
            runs.append(("half_batch", "half_batch"))
        if i == 0:
            runs.append(("unchanged", "unchanged"))
        for what, fault in runs:
            t0 = time.perf_counter()
            prog = train.Program(cell, seed, dev, tokens, fault=fault)
            try:
                got[what] = prog.first_steps()
            finally:
                prog.close()
                del prog
                harness.free_device()
            got[what]["seconds"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        precisions = ["float32"] + (["fp8"] if i < args.control else [])
        want, ref_peak = {}, {}
        for p in precisions:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            want[p] = train.reference_readings(cell, seed, dev, tokens, precision=p)
            want[p]["seconds"] = time.perf_counter() - t0
            ref_peak[p] = torch.cuda.max_memory_allocated(dev)
            harness.free_device()
        torch.cuda.reset_peak_memory_stats(dev)
        row = {"seed": seed, "program_peak_bytes": peak, "reference_peak_bytes": ref_peak,
               "seconds": {k: v["seconds"] for k, v in {**got, **want}.items()},
               "loss": {"reference": want["float32"]["loss"],
                        **{k: v["loss"] for k, v in got.items()}}}
        for what, readings in got.items():
            row[what] = check.gaps(readings, want["float32"])
        if "fp8" in want:
            row["control_fp8"] = check.gaps(want["fp8"], want["float32"])
        row["worst_leaf"] = {k: _worst(got["program"][k], want["float32"][k])
                             for k in ("grad", "change")}
        row["readings"] = {**got, **{f"reference_{k}": v for k, v in want.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(dev),
                       "rows": rows}, f, indent=1)
    return 0


def _worst(got: dict, want: dict) -> list:
    """The three leaves with the largest gaps relative to their own norm."""
    gaps = sorted(((abs(got[k] - w) / max(w, 1e-30), k, got[k], w) for k, w in want.items()),
                  reverse=True)
    return [[k, g, x, w] for g, k, x, w in gaps[:3]]


if __name__ == "__main__":
    sys.exit(main())
