#!/usr/bin/env python3
"""Time source variants of the port's flash attention kernels against each
other on one CUDA card, in one process: the forward at the serving shapes,
or (``--bwd``) the backward at phi4-mini-3.8b's training shape.

Each given ``.cu`` is a copy of ``src/repro_torch/csrc/flash_attention.cu``,
with or without the ``lse`` pointer in its C interface (the source is read
to tell which); each is built with the port's nvcc flags into
``build/time_flash/``, one nvcc each, all at once, checked once against the
plain version (bf16, 2e-2), then timed in turns (A B ... B A, ``--rounds``
times) with no lse written, as serving calls it, by CUDA events over
back-to-back launches at the qwen3-14b (B 8, S 512, H 40, K 8, hd 128) and
zamba2-7b (B 8, S 512, H 32, K 32, hd 112) prefill shapes. With ``--bwd``
each ``.cu`` is a copy of ``src/repro_torch/csrc/flash_attention_bwd.cu``
(its C interface unchanged), checked against the plain backward (2e-2 of
each output's max|grad|, bf16) and timed the same way at B 4, S 2048, H 24,
K 8, hd 128, causal, bf16. Prints one JSON line per variant and shape and
the card's name and power limit. Run from the repository root:

    python3 tools/time_flash_sources.py A.cu B.cu [--rounds 3] [--bwd]
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

SHAPES = {"qwen3-14b": (8, 512, 40, 8, 128), "zamba2-7b": (8, 512, 32, 32, 112)}
BWD_SHAPES = {"phi4-mini-3.8b train": (4, 2048, 24, 8, 128)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(paths: list[str]) -> list[str]:
    from repro_torch.kernels import build as kbuild
    out_dir = os.path.join(ROOT, "build", "time_flash")
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
    ap.add_argument("--bwd", action="store_true", help="time flash_attention_bwd variants")
    args = ap.parse_args()

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import (_BWD_SIGNATURES, flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_attention_plain)
    dev = resolve_device("cuda")
    variants = []
    for src, so in zip(args.sources, build(args.sources)):
        with_lse = "void* lse" in open(src).read()
        lib = ctypes.CDLL(so)
        if args.bwd:
            lib.flash_attention_bwd.argtypes = _BWD_SIGNATURES["flash_attention_bwd"]
            lib.flash_attention_bwd.restype = ctypes.c_int
        else:
            lib.flash_attention_fwd.argtypes = [_P] * (5 if with_lse else 4) + [_I] * 9 + [_P]
            lib.flash_attention_fwd.restype = ctypes.c_int
        variants.append((lib, with_lse))
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.bwd:
        return time_bwd(args, torch, dev, variants, stream, smi, flash_attention_cuda,
                        flash_attention_bwd_plain)

    def launch(variant, q, k, v, o):
        lib, with_lse = variant
        B, S, H, hd = q.shape
        K = k.shape[2]
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()] + [None] * with_lse
        err = lib.flash_attention_fwd(*ptrs, B, S, S, H, K, hd, 1, -1, 1, stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")

    for name, (B, S, H, K, hd) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        sets = [[torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                 for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))] for _ in range(4)]
        o = torch.empty_like(sets[0][0])
        want = flash_attention_plain(*sets[0])
        for i, variant in enumerate(variants):
            launch(variant, *sets[0], o)
            torch.cuda.synchronize()
            diff = (o.float() - want.float()).abs()
            if not bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all()):
                raise AssertionError(f"{args.sources[i]} disagrees with the plain version")
        times = time_in_turns(torch, len(variants),
                              lambda i, k: launch(variants[i], *sets[k % 4], o),
                              args.rounds, args.iters)
        for i, src in enumerate(args.sources):
            print(json.dumps({"source": src, "shape": name, "lse_in_interface": variants[i][1],
                              "ms": times[i], "mean_ms": sum(times[i]) / len(times[i]),
                              "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


def time_in_turns(torch, n: int, launch, rounds: int, iters: int) -> list[list[float]]:
    """Event-timed ms of ``launch(i, k)`` for variant i, turns A B .. B A."""
    order = list(range(n))
    times = [[] for _ in range(n)]
    for _ in range(rounds):
        for i in order + order[::-1]:
            for k in range(2):
                launch(i, k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for k in range(iters):
                launch(i, k)
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / iters)
    return times


def time_bwd(args, torch, dev, variants, stream, smi, flash_fwd, bwd_plain) -> int:
    for name, (B, S, H, K, hd) in BWD_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(4)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                       for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
        o, lse = flash_fwd(q, k, v, return_lse=True)
        f32 = dict(dtype=torch.float32, device=dev)
        D, dq_acc = torch.empty((B, H, S), **f32), torch.empty(q.shape, **f32)
        outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]

        def launch(i, _k):
            err = variants[i][0].flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), D.data_ptr(), dq_acc.data_ptr(), *(t.data_ptr() for t in outs),
                B, S, S, H, K, hd, 1, -1, 1, stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")

        want = bwd_plain(q, k, v, o, lse, do)
        errs = []
        for i in range(len(variants)):
            launch(i, 0)
            torch.cuda.synchronize()
            err = max(float((a.float() - w.float()).abs().max() / w.float().abs().max())
                      for a, w in zip(outs, want))
            if not err < 2e-2:
                raise AssertionError(f"{args.sources[i]} disagrees with the plain backward: {err}")
            errs.append(err)
        del want
        times = time_in_turns(torch, len(variants), launch, args.rounds, max(2, args.iters // 4))
        for i, src in enumerate(args.sources):
            print(json.dumps({"source": src, "shape": name, "err_of_max_grad": errs[i],
                              "ms": times[i], "mean_ms": sum(times[i]) / len(times[i]),
                              "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
