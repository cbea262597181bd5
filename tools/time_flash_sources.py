#!/usr/bin/env python3
"""Time source variants of the port's flash attention kernels against each
other on one CUDA card, in one process: the forward at the serving shapes,
or (``--bwd``) the backward at phi4-mini-3.8b's training shape.

Each given ``.cu`` is a copy of ``src/repro_torch/csrc/flash_attention.cu``,
with or without the ``lse`` pointer in its C interface (the source is read
to tell which); each is built with the port's nvcc flags into
``build/time_flash/`` (``csrc`` on the include path, for ``sm90.cuh``), one
nvcc each, all at once, checked once against the plain version (bf16,
2e-2), then timed in turns (A B ... B A, ``--rounds``
times) with no lse written, as serving calls it, by CUDA events over
back-to-back launches at the qwen3-14b (B 8, S 512, H 40, K 8, hd 128) and
zamba2-7b (B 8, S 512, H 32, K 32, hd 112) prefill shapes. With ``--bwd``
each ``.cu`` is a copy of ``src/repro_torch/csrc/flash_attention_bwd.cu``,
with or without the dq counters (``sem``) in its C interface, checked
against the plain backward (2e-2 of each output's max|grad|, bf16), run 5
times more to count the calls whose dq differs from the first's in any bit,
and timed the same way at the training shapes of ``BWD_SHAPES`` (bf16, or
``--dtype float32``, held to 1e-4).
Prints one JSON line per variant and shape and the card's name and power
limit. Run from the repository root:

    python3 tools/time_flash_sources.py A.cu B.cu [--rounds 3] [--bwd [--dtype float32]]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = {"qwen3-14b": (8, 512, 40, 8, 128), "zamba2-7b": (8, 512, 32, 32, 112)}
# (B, S, T, H, K, hd, causal): the training shapes of chip_smoke.py's kernel phase
BWD_SHAPES = {"phi4-mini-3.8b train": (4, 2048, 2048, 24, 8, 128, True),
              "granite-moe-1b-a400m train": (4, 2048, 2048, 16, 8, 64, True),
              "gemma3-12b global train": (4, 2048, 2048, 16, 8, 256, True),
              "whisper-tiny encoder train": (4, 1500, 1500, 6, 6, 64, False),
              "whisper-tiny cross train": (4, 448, 1500, 6, 6, 64, False)}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def build(paths: list[str]) -> list[str]:
    from repro_torch.kernels import build as kbuild
    out_dir = os.path.join(ROOT, "build", "time_flash")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"v{i}.so") for i in range(len(paths))]
    # -I: a copy outside csrc still finds the shared header csrc/sm90.cuh
    procs = [subprocess.Popen([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC),
                               "-o", o, p],
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the backward's inputs (with --bwd)")
    args = ap.parse_args()

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import (_BWD_SIGNATURES, bwd_sem_count,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_attention_plain)
    dev = resolve_device("cuda")
    variants = []
    for src, so in zip(args.sources, build(args.sources)):
        text = open(src).read()
        lib = ctypes.CDLL(so)
        # with or without the softmax scale argument (since hd 224)
        with_scale = "double scale" in text
        if args.bwd:
            # with or without the counters that order dq's additions
            with_ptr = "void* sem" in text
            lib.flash_attention_bwd.argtypes = ([_P] * (12 if with_ptr else 11) + [_I] * 9
                                                + [_D] * with_scale + [_P])
            lib.flash_attention_bwd.restype = ctypes.c_int
        else:
            with_ptr = "void* lse" in text
            lib.flash_attention_fwd.argtypes = ([_P] * (5 if with_ptr else 4) + [_I] * 9
                                                + [_D] * with_scale + [_P])
            lib.flash_attention_fwd.restype = ctypes.c_int
        variants.append((lib, with_ptr, with_scale))
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.bwd:
        return time_bwd(args, torch, dev, variants, stream, smi, flash_attention_cuda,
                        flash_attention_bwd_plain, bwd_sem_count)

    def launch(variant, q, k, v, o):
        lib, with_lse, with_scale = variant
        B, S, H, hd = q.shape
        K = k.shape[2]
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()] + [None] * with_lse
        err = lib.flash_attention_fwd(*ptrs, B, S, S, H, K, hd, 1, -1, 1,
                                      *[1.0 / math.sqrt(hd)] * with_scale, stream)
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


def time_bwd(args, torch, dev, variants, stream, smi, flash_fwd, bwd_plain, sem_count) -> int:
    for name, (B, S, T, H, K, hd, causal) in BWD_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(4)
        dtype = getattr(torch, args.dtype)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                       for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd)))
        o, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        f32 = dict(dtype=torch.float32, device=dev)
        D, dq_acc = torch.empty((B, H, S), **f32), torch.empty(q.shape, **f32)
        sem = torch.empty(sem_count(B, S, H), dtype=torch.int32, device=dev)
        # float32 writes dq into dq_acc itself, as the wrapper does
        outs = [dq_acc if dtype == torch.float32 else torch.empty_like(q),
                torch.empty_like(k), torch.empty_like(v)]

        def launch(i, _k):
            lib, with_sem, with_scale = variants[i]
            err = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), D.data_ptr(), dq_acc.data_ptr(),
                *([sem.data_ptr()] if with_sem else []), *(t.data_ptr() for t in outs),
                B, S, T, H, K, hd, int(causal), -1, int(dtype == torch.bfloat16),
                *[1.0 / math.sqrt(hd)] * with_scale, stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")

        want = bwd_plain(q, k, v, o, lse, do, causal=causal)
        errs, repeats = [], []
        for i in range(len(variants)):
            launch(i, 0)
            torch.cuda.synchronize()
            err = max(float((a.float() - w.float()).abs().max() / w.float().abs().max())
                      for a, w in zip(outs, want))
            if not err < (2e-2 if dtype == torch.bfloat16 else 1e-4):
                raise AssertionError(f"{args.sources[i]} disagrees with the plain backward: {err}")
            errs.append(err)
            # the calls of 5 more launches whose dq differs from the first's in any bit
            first = outs[0].clone()
            differ = 0
            for _ in range(5):
                launch(i, 0)
                torch.cuda.synchronize()
                differ += not torch.equal(outs[0], first)
            repeats.append(differ)
        del want
        times = time_in_turns(torch, len(variants), launch, args.rounds, max(2, args.iters // 4))
        for i, src in enumerate(args.sources):
            print(json.dumps({"source": src, "shape": name, "err_of_max_grad": errs[i],
                              "dtype": args.dtype, "dq_differs_in_repeats": repeats[i],
                              "of_repeats": 5,
                              "ms": times[i], "mean_ms": sum(times[i]) / len(times[i]),
                              "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
