"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Builds the cell named in ``BENCHMARK.json`` on one CUDA device, warms it up,
measures for ``--seconds`` and prints one JSON line: the end-to-end metrics
(``--trace 0``) or the per-layer ones from a profiled window (``--trace 1``).
The numbers that decide ``correct`` are printed beside their limits as the
last lines of standard error and under "checks", the line's last key.
Exits non-zero, printing no result, without a CUDA device, when the JAX
package or JAX is loaded, or when anything fails.

Build caches stay in the checkout: the port's nvcc output in
``build/kernels/`` (fixed by the program) and Triton's in
``build/triton/`` (set here before anything imports Triton).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from portbench import harness

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA devices, "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    result = kind.run(cell, args.seed, args.seconds, bool(args.trace), resolve_device("cuda"),
                      STARTED)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
