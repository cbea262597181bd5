#!/usr/bin/env python3
"""Time source variants of the port's SSD intra-chunk kernel against each
other on one CUDA card, in one process.

Each given ``.cu`` (a copy of ``src/repro_torch/csrc/ssd_intra_chunk.cu``
with its C interface unchanged) is built with the port's nvcc flags into
``build/time_ssd/``, one nvcc each, all at once; each is checked once against
the plain version at the tolerances of ``chip_smoke.py``, its largest error
against the float64 plain version with la > 0 in places is reported as a
share of those tolerances, and it is then timed in turns
(A B ... B A, ``--rounds`` times) at the zamba2-7b prefill shape (B 8, 4
chunks, Q 128, H 112, N 64, P 64, float32) by CUDA events over back-to-back
launches. Prints one JSON line per variant and the card's name and power
limit. Run from the repository root:

    python3 tools/time_ssd_sources.py A.cu B.cu [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPE = (8, 4, 128, 112, 64, 64)     # B, nc, Q, H, N, P
SSD_TOLS = (2e-4, 2e-4, 1e-5)        # y, state, tot, as chip_smoke.py
ACC_SHAPE = (2, 2, 128, 113, 64, 64)  # la = N(0,1) * 0.05, held to float64


def build(paths: list[str]) -> list[str]:
    from repro_torch.kernels import build as kbuild
    out_dir = os.path.join(ROOT, "build", "time_ssd")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"v{i}.so") for i in range(len(paths))]
    procs = [subprocess.Popen([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(paths, outs)]
    for p, proc in zip(paths, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {p} failed:\n{log}")
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.ssd_scan import _SIGNATURES, heads_per_block, ssd_intra_chunk_plain
    dev = resolve_device("cuda")
    libs = []
    for so in build(args.sources):
        lib = ctypes.CDLL(so)
        lib.ssd_intra_chunk_fwd.argtypes = _SIGNATURES["ssd_intra_chunk_fwd"]
        lib.ssd_intra_chunk_fwd.restype = ctypes.c_int
        libs.append(lib)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def inputs(shape, la_of, seed, n_sets=1):
        Bs, nc, Q, H, N, P = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        return [[la_of(torch.randn((Bs, nc, Q, H), generator=g, device=dev))]
                + [torch.randn(s, generator=g, device=dev)
                   for s in ((Bs, nc, Q, N), (Bs, nc, Q, N), (Bs, nc, Q, H, P))]
                for _ in range(n_sets)]

    def outputs(shape):
        Bs, nc, Q, H, N, P = shape
        return [torch.empty((Bs, nc, Q, H, P), device=dev),
                torch.empty((Bs, nc, H, P, N), device=dev), torch.empty((Bs, nc, H), device=dev)]

    def launch(lib, ins, outs, shape):
        Bs, nc, Q, H, N, P = shape
        err = lib.ssd_intra_chunk_fwd(*(t.data_ptr() for t in ins + outs), Bs * nc, Q, H, N, P,
                                      heads_per_block(Bs * nc, H, n_sm), stream)
        if err:
            raise RuntimeError(f"ssd_intra_chunk_fwd: CUDA error {err}")

    # two input sets in turns (x alone is 117 MB), checked against the plain version
    sets = inputs(SHAPE, lambda z: -z.abs() * 0.1, 2, n_sets=2)
    outs = outputs(SHAPE)
    want = ssd_intra_chunk_plain(*sets[0])
    errs = []
    for lib in libs:
        launch(lib, sets[0], outs, SHAPE)
        torch.cuda.synchronize()
        e = [float((o - w).abs().max()) for o, w in zip(outs, want)]
        ok = all(bool(((o - w).abs() <= t + t * w.abs()).all())
                 for o, w, t in zip(outs, want, SSD_TOLS))
        if not ok:
            raise AssertionError(f"variant {len(errs)} disagrees with the plain version: {e}")
        errs.append(max(e))

    # accuracy against the float64 plain version where la > 0 in places: the
    # largest |err| / (tol + tol |want|) over y, state and tot (1 = at the bound)
    acc_in = inputs(ACC_SHAPE, lambda z: z * 0.05, 9)[0]
    want64 = ssd_intra_chunk_plain(*(t.double() for t in acc_in))
    acc_out = outputs(ACC_SHAPE)
    shares = []
    for lib in libs:
        launch(lib, acc_in, acc_out, ACC_SHAPE)
        torch.cuda.synchronize()
        shares.append(max(float(((o.double() - w).abs() / (t + t * w.abs())).max())
                          for o, w, t in zip(acc_out, want64, SSD_TOLS)))

    order = list(range(len(libs)))
    times = [[] for _ in libs]
    for _ in range(args.rounds):
        for i in order + order[::-1]:
            for k in range(2):
                launch(libs[i], sets[k % 2], outs, SHAPE)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for k in range(args.iters):
                launch(libs[i], sets[k % 2], outs, SHAPE)
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / args.iters)
    for i, src in enumerate(args.sources):
        print(json.dumps({"source": src, "shape": list(SHAPE),
                          "max_abs_err": errs[i], "worst_tol_share_mixed_la": shares[i],
                          "ms": times[i],
                          "mean_ms": sum(times[i]) / len(times[i])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
