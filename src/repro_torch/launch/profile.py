"""Where the serving or training time goes on the card: a torch.profiler
breakdown.

Serving: builds the model (qwen3-14b by default, ``--arch zamba2-7b`` for
the hybrid, ``--arch qwen3-moe-30b-a3b`` for MoE, ``--arch gemma3-12b
--prompt-len 1536`` for the local/global pattern over a wrapped ring,
``--arch internvl2-2b`` with seeded patch embeddings, ``--arch xlstm-1.3b``
for the xLSTM, ``--arch whisper-tiny --prompt-len 416`` for the
encoder-decoder with zero frames; all its layers, bf16, random weights from
``--seed``), warms up,
then profiles two windows separately: one batched prefill, and the greedy
decode steps that follow it. Training (``--train``): phi4-mini-3.8b by
default at full width with ``--layers`` layers (by default as
``chip_smoke.py`` trains it: phi4-mini 8, granite-moe-1b-a400m 24,
gemma3-12b 6, one block of 5 local and 1 global, zamba2-7b 14, two groups
and a tail of 2, xlstm-1.3b 16, two blocks of 1 sLSTM and 7 mLSTM,
whisper-tiny all 4 decoder layers and its 4 encoder layers), bf16 params
and fp32 AdamW state, ``--batch`` x ``--seq`` tokens (4 x 2048;
whisper-tiny's ``--seq`` defaults to its 448-token text context), remat
"full"; one warm-up step, then one profiled train step. For each window
it prints one JSON line: host-clock wall time without and with the profiler,
device busy time (the union of kernel intervals) and idle share, and device
time by category (the port's kernels, matrix products, sorts and top-k,
gathers/scatters/index ops and scans, everything else) and by kernel. On a
MoE model the sort and gather categories hold the routing and dispatch (with
the embedding lookup and, in training, the loss's gather); a further line
splits the MoE layers' device time by function of ``models/moe.py``
(``moe_breakdown``, the program's spans recorded for that window only: one
prefill and one decode step, or the train step's forward and recompute).
Needs a CUDA device.

Run:  PYTHONPATH=src python -m repro_torch.launch.profile [--arch zamba2-7b] [--layers N]
      PYTHONPATH=src python -m repro_torch.launch.profile --train [--arch gemma3-12b] [--layers N]
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
from .. import spans
from .serve import model_inputs

CATEGORIES = (
    ("flash_attention", re.compile(r"flash_fwd_kernel")),
    ("flash_attention_bwd", re.compile(r"flash_bwd_kernel|bwd_prep_kernel|cast_kernel")),
    ("rmsnorm_bwd", re.compile(r"rmsnorm_bwd_kernel|colsum_kernel")),
    ("ssd_intra_chunk_bwd", re.compile(r"ssd_bwd_(heads|cb)")),
    ("decode_attention", re.compile(r"decode_(split|combine)_kernel")),
    ("rmsnorm", re.compile(r"rmsnorm_kernel")),
    ("ssd_intra_chunk", re.compile(r"ssd_intra_chunk_kernel")),
    ("matmul", re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas", re.I)),
    ("sort_topk", re.compile(r"sort|topk", re.I)),
    ("gather_scatter_index", re.compile(r"scatter|gather|index|scan", re.I)),
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


# --train's default depth a model
TRAIN_LAYERS = {"phi4-mini-3.8b": 8, "granite-moe-1b-a400m": 24, "gemma3-12b": 6,
                "zamba2-7b": 14, "xlstm-1.3b": 16, "whisper-tiny": 4}
# --train's default sequence length a model, where not 2048
TRAIN_SEQ = {"whisper-tiny": 448}

# functions of models/moe.py that moe_ffn calls, the ones that call no other first
MOE_FUNCTIONS = ("route", "dispatch_plan", "load_balance_aux", "experts")


def _moe_function(event):
    """The innermost ``moe.<name>`` span around an op, else None."""
    names = set()
    while event is not None:
        if event.name.startswith("moe."):
            names.add(event.name[4:])
        event = event.cpu_parent
    return next((n for n in MOE_FUNCTIONS if n in names), None)


def moe_breakdown(fn, device: torch.device) -> dict:
    """Device ms, by category, of the kernels that each function of
    ``models/moe.py`` launches in one run of ``fn()``: routing, the dispatch
    plan, the expert products with the gathers and the combine around them
    (``experts``), the aux. The profiler ties each kernel to the op that
    launched it (host activity on, so this window is slower than the
    others) and the op to the spans around it; kernels launched from
    elsewhere, the autograd backward included, are left out."""
    torch.cuda.synchronize(device)
    with spans.record(profiler=True), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    out: dict[str, dict[str, float]] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        where = _moe_function(e)
        if where is None:
            continue
        cats = out.setdefault(where, {})
        for k in e.kernels:
            cat = _category(k.name)
            cats[cat] = cats.get(cat, 0.0) + k.duration / 1e3
    if not out:
        raise RuntimeError("no device kernel was traced to a function of models/moe.py")
    return {f: dict(sorted(c.items())) for f, c in sorted(out.items())}


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
    batches = [to_device(loader.batch_at(i), cfg, dev) for i in range(3)]
    state["s"], _ = step(state["s"], batches[0])                     # warm-up

    def run_step():
        state["s"], _ = step(state["s"], batches[1])

    meta = {"cfg": f"{cfg.name} n_layers={cfg.n_layers} {cfg.dtype}, fp32 AdamW",
            "B": args.batch, "S": args.seq, "remat": rt.remat,
            "device": torch.cuda.get_device_name(dev)}
    out = {"window": "train step", **meta, **profile_window(run_step, dev, args.top)}
    print(json.dumps(out), flush=True)
    res = {"train step": out}
    if cfg.family == "moe":
        res["moe"] = {"window": "train step, MoE layers (forward and recompute)", **meta,
                      "device_ms_by_function": moe_breakdown(run_step, dev)}
        print(json.dumps(res["moe"]), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="qwen3-14b for serving, phi4-mini-3.8b with --train")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth (default: all; with --train, TRAIN_LAYERS' or 8)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--train", action="store_true", help="profile one train step")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=None, help="with --train: TRAIN_SEQ's or 2048")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    if args.train:
        args.arch = args.arch or "phi4-mini-3.8b"
        args.layers = args.layers or TRAIN_LAYERS.get(args.arch, 8)
        args.seq = args.seq or TRAIN_SEQ.get(args.arch, 2048)
        return profile_train(args, dev)
    cfg = get_config(args.arch or "qwen3-14b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    B, P, G = args.requests, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    batch = {"tokens": prompts, **model_inputs(cfg, B, dev, args.seed + 2)}
    S_max = P + G + cfg.n_patches * (cfg.family == "vlm")

    def prefill():
        return model.prefill(params, batch, S_max)

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
    if cfg.family == "moe":
        def one_decode_step():
            model.decode_step(params, state["cache"], {"token": torch.argmax(state["logits"], -1)})

        out["moe"] = {"window": "MoE layers", **meta,
                      "device_ms_by_function": {"prefill": moe_breakdown(run_prefill, dev),
                                                "decode step": moe_breakdown(one_decode_step,
                                                                             dev)}}
        print(json.dumps(out["moe"]), flush=True)
    return out


if __name__ == "__main__":
    main()
