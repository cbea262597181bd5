#!/usr/bin/env python3
"""Time the hybrid family (``zamba2-7b``) where the chunked SSD scan runs:
the scan alone (``models.mamba2.ssd_chunked``, its forward, and forward and
backward at the training shape), a batched prefill, a long prompt, and a
training step's loss and gradients, on one CUDA card.

Made to compare two trees of the port on one card: run it once with
each tree's ``src`` first on PYTHONPATH, in turns (A B B A), and compare the
medians. Each case is warmed up, then timed ``--reps`` times by CUDA events;
prints the card's name and power limit and one JSON line a case. Shapes:
the scan at 112 heads of 64, state 64, chunk 128, float32 (B 8 at 4, 8 and
12 chunks a row, where the scan's two forms meet; B 1 at ``--long`` and 4
times as many tokens); the prefill as
``chip_smoke.py`` serves it (all 81 layers, B 8 x 512) and one prompt of
``--long`` tokens; the step as ``chip_smoke.py`` trains it (14 layers, B 4 x
2048, remat "full"). ``--small`` runs tiny shapes on the CPU, to try it.

    PYTHONPATH=src python3 tools/time_hybrid_scan.py [--reps 5] [--long 32768]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch


def timed(fn, reps: int, dev) -> dict:
    fn()
    ms = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}


def scan_cases(dev, small: bool, long: int):
    from repro_torch.models.mamba2 import ssd_chunked
    H, P, N, Q = (4, 8, 8, 16) if small else (112, 64, 64, 128)
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, grad):
        x = torch.randn((B, S, H, P), generator=g, device=dev)
        dt = torch.rand((B, S, H), generator=g, device=dev) * 0.1
        Bm = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.1
        Cm = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.1
        A = -torch.rand((H,), generator=g, device=dev) - 0.5
        if grad:
            for t in (x, dt, Bm, Cm):
                t.requires_grad_(True)
        return x, dt, A, Bm, Cm

    shapes = [(2, 64), (1, 256)] if small else [(8, 512), (8, 1024), (8, 1536), (1, long),
                                                (1, 4 * long)]
    for B, S in shapes:
        x, dt, A, Bm, Cm = inputs(B, S, False)
        with torch.no_grad():
            yield f"scan forward B{B} S{S}", lambda: ssd_chunked(x, dt, A, Bm, Cm, Q)
        del x, dt, Bm, Cm
    B, S = (2, 64) if small else (4, 2048)
    x, dt, A, Bm, Cm = inputs(B, S, True)

    def fwd_bwd():
        y, h = ssd_chunked(x, dt, A, Bm, Cm, Q)
        torch.autograd.grad((y.sum() + h.sum()), (x, dt, Bm, Cm))
    yield f"scan forward and backward B{B} S{S}", fwd_bwd


def model_cases(dev, small: bool, long: int):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    if small:
        from repro_torch.configs.zamba2_7b import SMOKE as full
    else:
        full = get_config("zamba2-7b")
    serve_layers = 7 if small else full.n_layers
    cfg = dataclasses.replace(full, n_layers=serve_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, S in ([(2, 64), (1, 128)] if small else [(8, 512), (1, long)]):
        tok = torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=gen)
        with torch.no_grad():
            yield f"prefill {cfg.n_layers} layers B{B} x {S}", \
                lambda: model.prefill(params, {"tokens": tok}, S + 1)
    del params
    cfg = dataclasses.replace(full, n_layers=7 if small else 14)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    leaves = [t.requires_grad_(True) for t in _leaves(params)]
    B, S = (2, 64) if small else (4, 2048)
    tok = torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=gen)

    def step():
        loss, _ = model.loss(params, {"tokens": tok, "labels": tok}, remat="full")
        torch.autograd.grad(loss, leaves)
    yield f"train loss and grads {cfg.n_layers} layers B{B} x {S}", step


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) and tree.is_floating_point() else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--long", type=int, default=32768)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    import repro_torch
    dev = torch.device("cpu" if args.small else "cuda")
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"card": card.stdout.strip(), "tree": repro_torch.__file__}), flush=True)
    for cases in (scan_cases, model_cases):
        for name, fn in cases(dev, args.small, args.long):
            print(json.dumps({"case": name, **timed(fn, args.reps, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
