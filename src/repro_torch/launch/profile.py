"""Where the serving or training time goes on the card: a torch.profiler
breakdown.

Serving: builds the model (qwen3-14b by default, ``--arch zamba2-7b`` for
the hybrid; all its layers, bf16, random weights from ``--seed``), warms up,
then profiles two windows separately: one batched prefill, and the greedy
decode steps that follow it. Training (``--train``): phi4-mini-3.8b by
default at full width with ``--layers`` (default 8) layers, bf16 params and
fp32 AdamW state, ``--batch`` x ``--seq`` tokens (4 x 2048), remat "full";
one warm-up step, then one profiled train step. For each window it prints
one JSON line: host-clock wall time without and with the profiler, device
busy time (the union of kernel intervals) and idle share, and device time by
category (the port's kernels, matrix products, everything else) and by
kernel. Needs a CUDA device.

Run:  PYTHONPATH=src python -m repro_torch.launch.profile [--arch zamba2-7b] [--layers N]
      PYTHONPATH=src python -m repro_torch.launch.profile --train [--layers 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model

CATEGORIES = (
    ("flash_attention", re.compile(r"flash_fwd_kernel")),
    ("flash_attention_bwd", re.compile(r"flash_bwd_kernel|bwd_prep_kernel|cast_kernel")),
    ("rmsnorm_bwd", re.compile(r"rmsnorm_bwd_kernel|colsum_kernel")),
    ("decode_attention", re.compile(r"decode_(split|combine)_kernel")),
    ("rmsnorm", re.compile(r"rmsnorm_kernel")),
    ("ssd_intra_chunk", re.compile(r"ssd_intra_chunk_kernel")),
    ("matmul", re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas", re.I)),
)


def _category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _wall_ms(fn, device: torch.device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def profile_window(fn, device: torch.device, top: int) -> dict:
    """Run ``fn()`` once unprofiled for its wall time, then once under the
    profiler (device activity only, to keep host overhead low); summarise
    the device kernels of the profiled run."""
    unprofiled = _wall_ms(fn, device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_name: dict[str, float] = {}
    by_cat: dict[str, float] = {}
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + dt
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    top_names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "unprofiled_wall_ms": unprofiled,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": max(0.0, 1.0 - busy / wall_us),
        "kernel_launches": len(kernels),
        "device_ms_by_category": {k: v / 1e3 for k, v in sorted(by_cat.items())},
        "top_kernels_ms": [[n[:120], v / 1e3] for n, v in top_names],
    }


def profile_train(args, dev: torch.device) -> dict:
    from ..data import DatasetSpec, Loader
    from ..launch.train import to_device
    from ..optim import AdamWConfig
    from ..runtime import RuntimeConfig, make_train_state, make_train_step
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", opt=AdamWConfig(lr=1e-4), schedule="constant")
    state = {"s": make_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                                   rt)}
    loader = Loader(DatasetSpec(seed=7, vocab=cfg.vocab_size, n_tokens=1 << 24),
                    batch=args.batch, seq=args.seq)
    step = make_train_step(model, rt)
    batches = [to_device(loader.batch_at(i), dev) for i in range(3)]
    state["s"], _ = step(state["s"], batches[0])                     # warm-up

    def run_step():
        state["s"], _ = step(state["s"], batches[1])

    meta = {"cfg": f"{cfg.name} n_layers={cfg.n_layers} {cfg.dtype}, fp32 AdamW",
            "B": args.batch, "S": args.seq, "remat": rt.remat,
            "device": torch.cuda.get_device_name(dev)}
    out = {"window": "train step", **meta, **profile_window(run_step, dev, args.top)}
    print(json.dumps(out), flush=True)
    return {"train step": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="qwen3-14b for serving, phi4-mini-3.8b with --train")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth (default: all; 8 with --train)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--train", action="store_true", help="profile one train step")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    if args.train:
        args.arch = args.arch or "phi4-mini-3.8b"
        args.layers = args.layers or 8
        return profile_train(args, dev)
    cfg = get_config(args.arch or "qwen3-14b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    B, P, G = args.requests, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    S_max = P + G

    def prefill():
        return model.prefill(params, {"tokens": prompts}, S_max)

    logits, cache = prefill()                                   # warm-up
    model.decode_step(params, cache, {"token": torch.argmax(logits, -1)})
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill()

    def run_decode():
        tok = torch.argmax(state["logits"], dim=-1)
        cache = state["cache"]
        for _ in range(G - 1):
            logits, cache = model.decode_step(params, cache, {"token": tok})
            tok = torch.argmax(logits, dim=-1)

    meta = {"cfg": f"{cfg.name} n_layers={cfg.n_layers} {cfg.dtype}", "B": B, "prompt": P,
            "gen": G, "device": torch.cuda.get_device_name(dev)}
    out = {}
    for name, fn in (("prefill", run_prefill), (f"decode x{G - 1}", run_decode)):
        out[name] = {"window": name, **meta, **profile_window(fn, dev, args.top)}
        print(json.dumps(out[name]), flush=True)
    return out


if __name__ == "__main__":
    main()
