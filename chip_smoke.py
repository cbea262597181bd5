#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each printing one JSON line to stdout:

  build      compile every CUDA source with nvcc (one process each, in parallel)
  kernel     each kernel against its plain PyTorch version on the card, bf16
             (tolerance 2e-2) and float32 (2e-5, TF32 off), with kernel, plain
             and one-PyTorch-call (``library_ms``, a yardstick the port never
             calls) times
  reference  qwen3-14b widths, 2 layers, float32: the card's kernel path
             against the plain path on the CPU with the same weights
  staged     ``repro_torch.launch.serve.serve`` at qwen3-14b widths with 2
             layers: publish, stage ~4.4 GB through the burst tier, restore,
             prefill 8 x 512 and decode 32 tokens
  full       qwen3-14b, all 40 layers, bf16, weights from a seeded generator
             on the card, no staging: the same batch, timed
  kernels    per kernel: launches in the staged and full runs, error, times,
             bound; the launch counts must equal what the path implies

Then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor cores; f32 non-tensor
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
B, PROMPT, GEN = 8, 512, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotating(sets):
    """Call-by-call rotation over input copies, so a timed kernel does not
    find its inputs in the 50 MB L2 from the previous call."""
    state = {"i": 0}

    def next_set():
        s = sets[state["i"] % len(sets)]
        state["i"] += 1
        return s
    return next_set


def copies_for(nbytes: int) -> int:
    return max(1, min(8, math.ceil(128e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_ok(torch, out, want, tol: float) -> tuple[float, bool]:
    o, w = out.float(), want.float()
    if not torch.isfinite(o).all():
        return float("nan"), False
    diff = (o - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


# -- kernel phases -------------------------------------------------------------
def kernel_cases(torch):
    """One dict per case: ``make(dtype)`` builds the inputs on the card; ``run``
    launches the kernel (uncounted), ``plain`` is its plain version, ``library``
    one PyTorch call computing the same function; ``nbytes(itemsize)`` and
    ``flops`` are the work this case's inputs need; ``main`` marks the shape
    the full model's path gives the kernel."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain, rmsnorm_triton
    F = torch.nn.functional
    dev = torch.device("cuda")
    cases = []

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for shape in [(B * PROMPT, 5120), (B * PROMPT * 40, 128), (2, 33, 128), (1, 1, 512)]:
        def make(dtype, shape=shape):
            g = torch.Generator(device=dev).manual_seed(3)
            return {"x": randn(g, shape, dtype), "scale": randn(g, shape[-1:], dtype)}
        n = math.prod(shape)
        cases.append(dict(
            kernel="rmsnorm", desc={"shape": list(shape)}, make=make,
            run=lambda a: rmsnorm_triton(a["x"], a["scale"]),
            plain=lambda a: rmsnorm_plain(a["x"], a["scale"]),
            library=lambda a: F.rms_norm(a["x"], (a["x"].shape[-1],), a["scale"], 1e-5),
            nbytes=lambda isz, n=n, d=shape[-1]: 2 * n * isz + d * isz,
            flops=4 * n, main=(shape == (B * PROMPT, 5120))))

    def flash_make(Bq, S, window):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(0)
            a = {"q": randn(g, (Bq, S, 40, 128), dtype), "k": randn(g, (Bq, S, 8, 128), dtype),
                 "v": randn(g, (Bq, S, 8, 128), dtype), "window": window}
            # library yardstick: SDPA on (B, H, S, hd) with kv heads expanded
            a["lq"] = a["q"].transpose(1, 2)
            a["lk"] = a["k"].repeat_interleave(5, dim=2).transpose(1, 2)
            a["lv"] = a["v"].repeat_interleave(5, dim=2).transpose(1, 2)
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(S, device=dev)[None, :]
            ok = cols <= rows
            if window is not None:
                ok = ok & (cols > rows - window)
            a["mask"] = None if window is None else ok
            return a
        return make

    for Bq, S, window in [(2, 512, None), (2, 500, None), (2, 512, 64), (B, PROMPT, None)]:
        pairs = sum(min(r + 1, window or r + 1) for r in range(S))   # valid (row, col)
        cases.append(dict(
            kernel="flash_attention", desc={"B": Bq, "S": S, "T": S, "H": 40, "K": 8,
                                            "hd": 128, "causal": True, "window": window},
            make=flash_make(Bq, S, window),
            run=lambda a: flash_attention_cuda(a["q"], a["k"], a["v"], causal=True,
                                               window=a["window"]),
            plain=lambda a: flash_attention_plain(a["q"], a["k"], a["v"], causal=True,
                                                  window=a["window"]),
            library=lambda a: F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=a["mask"], is_causal=a["mask"] is None),
            nbytes=lambda isz, Bq=Bq, S=S: (2 * Bq * S * 40 * 128 + 2 * Bq * S * 8 * 128) * isz,
            flops=4 * Bq * 40 * 128 * pairs, main=(Bq == B)))

    T = PROMPT + GEN
    for kv_len in (1, 37, 300, T, PROMPT + GEN // 2):
        for window in (None, 64):
            if kv_len == PROMPT + GEN // 2 and window is not None:
                continue
            def make(dtype, kv_len=kv_len, window=window):
                g = torch.Generator(device=dev).manual_seed(1)
                a = {"q": randn(g, (B, 1, 40, 128), dtype), "k": randn(g, (B, T, 8, 128), dtype),
                     "v": randn(g, (B, T, 8, 128), dtype), "window": window,
                     "kv_len": torch.tensor(kv_len, dtype=torch.int32, device=dev)}
                lo = 0 if window is None else max(0, kv_len - window)
                a["lq"] = a["q"].transpose(1, 2)
                a["lk"] = a["k"][:, lo:kv_len].repeat_interleave(5, dim=2).transpose(1, 2)
                a["lv"] = a["v"][:, lo:kv_len].repeat_interleave(5, dim=2).transpose(1, 2)
                return a
            valid = kv_len if window is None else min(kv_len, window)
            cases.append(dict(
                kernel="decode_attention",
                desc={"B": B, "T": T, "H": 40, "K": 8, "hd": 128, "kv_len": kv_len,
                      "window": window},
                make=make,
                run=lambda a: decode_attention_cuda(a["q"], a["k"], a["v"], kv_len=a["kv_len"],
                                                    window=a["window"]),
                plain=lambda a: decode_attention_plain(a["q"], a["k"], a["v"],
                                                       kv_len=a["kv_len"], window=a["window"]),
                library=lambda a: F.scaled_dot_product_attention(a["lq"], a["lk"], a["lv"]),
                nbytes=lambda isz, v=valid: (2 * B * 40 * 128 + 2 * B * v * 8 * 128) * isz,
                flops=4 * B * 40 * 128 * valid, main=(kv_len == PROMPT + GEN // 2)))
    return cases


def run_kernel_phase(torch) -> dict:
    """Compare and time every case; return the main-path row per kernel."""
    main_rows, failures = {}, []
    for case in kernel_cases(torch):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            a = case["make"](dtype)
            out = case["run"](a)
            want = case["plain"](a)
            torch.cuda.synchronize()
            err, ok = max_err_ok(torch, out, want, TOL[dtype_name])
            isz = 2 if dtype_name == "bfloat16" else 4
            nbytes = case["nbytes"](isz)
            sets = rotating([a] + [case["make"](dtype) for _ in range(copies_for(nbytes) - 1)])
            ms = time_ms(torch, lambda: case["run"](sets()))
            plain_ms = time_ms(torch, lambda: case["plain"](sets()))
            lib_ms = time_ms(torch, lambda: case["library"](sets()))
            bound_ms, bound_by = bound(nbytes, case["flops"], dtype_name)
            row = {"phase": "kernel", "kernel": case["kernel"], **case["desc"],
                   "dtype": dtype_name, "max_abs_err": err, "tol": TOL[dtype_name], "ok": ok,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(row)
            if not ok:
                failures.append(row)
            if case["main"] and dtype_name == "bfloat16":
                main_rows[case["kernel"]] = row
            del sets, a, out, want
    if failures:
        raise AssertionError(f"{len(failures)} kernel case(s) disagree with the plain version")
    return main_rows


# -- model phases ----------------------------------------------------------------
def expected_launches(L: int, gen: int) -> dict:
    """One prefill and gen - 1 decode steps: flash L per prefill, decode L per
    step, rmsnorm 2L + 1 layer norms and 2L qk-norms per forward."""
    return {"flash_attention": L, "decode_attention": L * (gen - 1),
            "rmsnorm": (4 * L + 1) * gen}


def run_reference_phase(torch) -> None:
    """qwen3-14b widths, 2 layers, float32: kernels on the card against the
    plain path on the CPU, same weights and prompts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2, dtype="float32")
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 32), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    card = generate(model, params, prompts, 4)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    host = generate(model, cpu_params, prompts.cpu(), 4)
    a, b = card["last_logits"].float().cpu(), host["last_logits"].float()
    rel = float((a - b).abs().max() / b.abs().max())
    same = bool(torch.equal(card["tokens"].cpu(), host["tokens"]))
    emit({"phase": "reference", "cfg": "qwen3-14b n_layers=2 float32", "B": 2, "prompt": 32,
          "gen": 4, "logits_rel_err": rel, "tol": 1e-4, "tokens_equal": same})
    if not (rel < 1e-4 and same):
        raise AssertionError("card kernel path disagrees with the CPU plain path")


def check_output(tokens, vocab: int, shape) -> None:
    if tuple(tokens.shape) != shape:
        raise AssertionError(f"generated shape {tuple(tokens.shape)} != {shape}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
        raise AssertionError("generated token outside the (padded) vocabulary")


def check_launches(got: dict, want: dict, phase: str) -> None:
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got} != expected {want}")


def run_staged_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2)
    t0 = time.perf_counter()
    ops.reset_launches()
    res = serve(cfg, requests=B, prompt_len=PROMPT, gen=GEN, seed=0, device="cuda", log=log)
    got = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not (res["stage_bytes"] == res["published_bytes"]
            and 0 < res["published_bytes"] - res["manifest_bytes"] < 1 << 20):
        raise AssertionError("staged bytes differ from what was published")
    emit({"phase": "staged", "cfg": "qwen3-14b n_layers=2 bf16", "B": B, "prompt": PROMPT,
          "gen": GEN, "stage_bytes": res["stage_bytes"], "manifest_bytes": res["manifest_bytes"],
          "stage_modeled_s": res["stage_modeled_s"], "load_modeled_s": res["load_modeled_s"],
          "generated": list(res["generated"]), "prefill_s": res["prefill_s"],
          "decode_s": res["decode_s"], "wall_s": wall, "launches": got})
    check_launches(got, expected_launches(cfg.n_layers, GEN), "staged")
    return got


def run_full_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    cfg = get_config("qwen3-14b")
    model = build_model(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    generate(model, params, prompts, 2)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = generate(model, params, prompts, GEN)
    got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not torch.isfinite(res["last_logits"].float()).all():
        raise AssertionError("non-finite logits")
    steps = GEN - 1
    emit({"phase": "full", "cfg": "qwen3-14b 40 layers bf16", "params": n_params,
          "weight_bytes": n_params * 2, "init_s": init_s, "B": B, "prompt": PROMPT, "gen": GEN,
          "prefill_ms": res["prefill_s"] * 1e3,
          "decode_ms_per_step": res["decode_s"] / steps * 1e3,
          "decode_tokens_per_s": B * steps / res["decode_s"],
          "tokens_per_s": B * GEN / (res["prefill_s"] + res["decode_s"]),
          "peak_memory_bytes": peak, "launches": got})
    check_launches(got, expected_launches(cfg.n_layers, GEN), "full")
    return got


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:35"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:100"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:90"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    try:
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        log(f"chip_smoke: the port is not here ({e}); run from the repository root")
        return 2
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "sources": sorted(built), "seconds": time.perf_counter() - t0})

    main_rows = run_kernel_phase(torch)
    run_reference_phase(torch)
    torch.cuda.empty_cache()
    staged = run_staged_phase(torch)
    torch.cuda.empty_cache()
    full = run_full_phase(torch)

    rows = []
    for name in ("rmsnorm", "flash_attention", "decode_attention"):
        route, source, replaces = SOURCES[name]
        r = main_rows[name]
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": staged[name] + full[name],
                     "launches_staged": staged[name], "launches_full": full[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
