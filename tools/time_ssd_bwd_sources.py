#!/usr/bin/env python3
"""Time source variants of the port's SSD intra-chunk backward kernel against
each other on one CUDA card, in one process.

Each given ``.cu`` (a copy of ``src/repro_torch/csrc/ssd_intra_chunk_bwd.cu``
with its C interface unchanged) is built with the port's nvcc flags and
``-Xptxas -v`` into ``build/time_ssd_bwd/``, one nvcc each, all at once; the
registers, spills and shared memory ptxas reports for each kernel are kept.
Each variant is checked once against the plain version in float64 (autograd
through the plain forward) at zamba2-7b's training shape with la in the
model's range and at (2, 2, 128, 113, 64, 64) with la > 0 in places, its
worst error over dla, dC, dB and dx reported as a share of max|grad|
(``chip_smoke.py`` holds it to 1e-4), and it is then timed in turns
(A B ... B A, ``--rounds`` times) at the training shape (B 4, 16 chunks, Q
128, H 112, N 64, P 64) and the prefill shape (B 8, 4 chunks), by CUDA
events over back-to-back launches with two input sets in turn. Every
variant takes the same head groups (``bwd_heads_per_block``) and scratch
sized for Q rounded up to 16. Prints one JSON line per variant
and shape, and the card's name and power limit. Run from the repository
root:

    python3 tools/time_ssd_bwd_sources.py A.cu B.cu [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = {"train": (4, 16, 128, 112, 64, 64), "prefill": (8, 4, 128, 112, 64, 64)}
CHECKS = [((4, 16, 128, 112, 64, 64), "model"), ((2, 2, 128, 113, 64, 64), "mixed")]
GRAD_TOL = 1e-4


def build(paths: list[str]) -> tuple[list[str], list[list[str]]]:
    """Build each source; return the libraries and each one's ptxas lines
    (registers, spills, shared memory) per kernel."""
    from repro_torch.kernels import build as kbuild
    out_dir = os.path.join(ROOT, "build", "time_ssd_bwd")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"v{i}.so") for i in range(len(paths))]
    procs = [subprocess.Popen([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                               str(kbuild.CSRC), "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(paths, outs)]
    reports = []
    for p, proc in zip(paths, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {p} failed:\n{log}")
        reports.append([" ".join(line.split()) for line in log.splitlines()
                        if re.search(r"Compiling entry|registers|spill", line)])
    return outs, reports


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.kernels.ssd_scan import (_BWD_SIGNATURES, bwd_heads_per_block,
                                              ssd_intra_chunk_bwd_plain)
    dev = resolve_device("cuda")
    sources = args.sources
    sos, reports = build(sources)
    libs = []
    for so in sos:
        lib = ctypes.CDLL(so)
        lib.ssd_intra_chunk_bwd.argtypes = _BWD_SIGNATURES["ssd_intra_chunk_bwd"]
        lib.ssd_intra_chunk_bwd.restype = ctypes.c_int
        libs.append(lib)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def inputs(shape, la_kind, seed):
        Bs, nc, Q, H, N, P = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        z = torch.randn((Bs, nc, Q, H), generator=g, device=dev)
        la = {"small": -z.abs() * 0.1, "model": -F.softplus(z), "mixed": z * 0.05}[la_kind]
        return [la] + [torch.randn(s, generator=g, device=dev)
                       for s in ((Bs, nc, Q, N), (Bs, nc, Q, N), (Bs, nc, Q, H, P),
                                 (Bs, nc, Q, H, P), (Bs, nc, H, P, N), (Bs, nc, H))]

    def outputs(shape):
        Bs, nc, Q, H, N, P = shape
        BC, Qp = Bs * nc, -(-Q // 16) * 16
        hg = bwd_heads_per_block(BC, H, n_sm)
        ngrp = math.ceil(H / hg)
        outs = [torch.empty(s, device=dev) for s in ((Bs, nc, Q, H), (Bs, nc, Q, N),
                                                     (Bs, nc, Q, N), (Bs, nc, Q, H, P),
                                                     (BC, ngrp, Qp, Qp), (BC, ngrp, Qp, N))]
        return outs, hg

    def launch(lib, ins, outs, hg, shape):
        Bs, nc, Q, H, N, P = shape
        dla, dC, dB, dx, pdcb, pdbh = outs
        err = lib.ssd_intra_chunk_bwd(*(t.data_ptr() for t in ins),
                                      *(t.data_ptr() for t in (dla, dx, dC, dB, pdcb, pdbh)),
                                      Bs * nc, Q, H, N, P, hg, stream)
        if err:
            raise RuntimeError(f"ssd_intra_chunk_bwd: CUDA error {err}")

    shares = [{} for _ in libs]
    for shape, la_kind in CHECKS:
        ins = inputs(shape, la_kind, 6)
        want = ssd_intra_chunk_bwd_plain(*(t.double() for t in ins))
        outs, hg = outputs(shape)
        for i, lib in enumerate(libs):
            launch(lib, ins, outs, hg, shape)
            torch.cuda.synchronize()
            share = max(float((o.double() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                        for o, w in zip(outs[:4], want))
            if not share <= GRAD_TOL:
                raise AssertionError(f"{sources[i]} at {shape}, la {la_kind}: "
                                     f"{share:.3g} of max|grad| off float64")
            shares[i][f"{la_kind} {list(shape)}"] = share
        del ins, want, outs

    for name, shape in SHAPES.items():
        sets = [inputs(shape, "model", 2 + k) for k in range(2)]
        outs, hg = outputs(shape)
        order = list(range(len(libs)))
        times = [[] for _ in libs]
        for _ in range(args.rounds):
            for i in order + order[::-1]:
                for k in range(2):
                    launch(libs[i], sets[k % 2], outs, hg, shape)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for k in range(args.iters):
                    launch(libs[i], sets[k % 2], outs, hg, shape)
                end.record()
                end.synchronize()
                times[i].append(start.elapsed_time(end) / args.iters)
        for i, src in enumerate(sources):
            print(json.dumps({"source": src, "shape_name": name, "shape": list(shape),
                              "heads_per_block": hg, "ms": times[i],
                              "mean_ms": sum(times[i]) / len(times[i]),
                              "worst_share_of_max_grad": shares[i], "ptxas": reports[i]}),
                  flush=True)
        del sets, outs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
