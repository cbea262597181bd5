#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each printing one JSON line to stdout:

  build      compile every CUDA source with nvcc (one process each, in parallel)
  kernel     each kernel against its plain PyTorch version on the card, at the
             shapes the qwen3-14b and zamba2-7b paths give it: bf16 (tolerance
             2e-2) and float32 (2e-5, TF32 off); ssd_intra_chunk float32 only,
             2e-4 on y and state and 1e-5 on tot. Kernel, plain and
             one-PyTorch-call (``library_ms``, a yardstick the port never calls)
             times
  reference  card kernel path against the CPU plain path, same weights:
             qwen3-14b widths with 2 layers, zamba2-7b widths with 7 layers
             (a group of 6 and a tail of 1), float32
  staged     ``repro_torch.launch.serve.serve`` publish -> stage through the
             burst tier -> restore -> prefill 8 x 512 -> decode 32 tokens:
             qwen3-14b with 2 layers (~4.4 GB staged), zamba2-7b with 7
             layers (~2.0 GB)
  full       qwen3-14b (40 layers) and zamba2-7b (81 layers), bf16, weights
             from a seeded generator on the card, no staging: the same batch,
             timed
  kernels    per kernel: launches in every staged and full run, error, times,
             bound; each run's launch counts must equal what its path implies

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
# bf16 and TF32 on the tensor cores; float32 outside them (NVIDIA data sheet,
# SXM, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SSD_TOLS = (2e-4, 2e-4, 1e-5)      # y, state, tot (tests/test_kernels.py:81-83)
B, PROMPT, GEN = 8, 512, 32
QWEN, ZAMBA = "qwen3-14b", "zamba2-7b"


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


def device_ms(torch, fn, iters: int = 10, warmup: int = 2, tries: int = 3):
    """Mean summed device time of the kernels one ``fn()`` launches, from
    torch.profiler (as ``repro_torch.launch.profile`` reads a window).

    Now and then a profiler window comes back with no device activity at
    all (seen on an H100 with torch 2.11); the window is then
    taken again, and after ``tries`` empty windows the time is None: not
    measured. Whether the kernel ran is checked by its output, not here."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / iters / 1e3
        log("chip_smoke: a profiler window recorded no device activity; taking it again")
    return None


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


def bound_parts(nbytes: float, flops, dtype: str) -> tuple[float, float]:
    """Least ms for the bytes at the HBM rate and for the flops at the peak:
    ``flops`` is a count at ``dtype``'s peak, or ``{rate: count}`` for work
    that runs at several (keys of PEAK_FLOPS)."""
    work = flops if isinstance(flops, dict) else {dtype: flops}
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            sum(n / PEAK_FLOPS[k] for k, n in work.items()) * 1e3)


def bound(nbytes: float, flops, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = bound_parts(nbytes, flops, dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_ok(torch, out, want, tol: float) -> tuple[float, bool]:
    o, w = out.float(), want.float()
    if not torch.isfinite(o).all():
        return float("nan"), False
    diff = (o - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def compare(torch, out, want, tols) -> tuple[float, bool]:
    """Largest error and whether every output is within its tolerance;
    ``out``/``want`` are one tensor or a tuple of them, one tolerance each."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    res = [max_err_ok(torch, o, w, t) for o, w, t in zip(outs, wants, tols)]
    return max(e for e, _ in res), all(ok for _, ok in res)


# -- kernel phases -------------------------------------------------------------
def kernel_cases(torch):
    """One dict per case: ``make(dtype)`` builds the inputs on the card; ``run``
    launches the kernel (uncounted), ``plain`` is its plain version, ``oracle``
    (where given) what the kernel is held to instead of ``plain``, ``library``
    one PyTorch call computing the same function (or None); ``nbytes(itemsize)``
    and ``flops`` are the work this case's inputs need; ``main`` names the
    path (qwen3-14b or zamba2-7b) whose full model gives the kernel this
    shape; ``dtypes`` and ``tols`` where the defaults do not hold."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain, rmsnorm_triton
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_cuda, ssd_intra_chunk_plain
    F = torch.nn.functional
    dev = torch.device("cuda")
    cases = []

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for shape, main in [((B * PROMPT, 5120), QWEN), ((B * PROMPT * 40, 128), None),
                        ((B * PROMPT, 3584), ZAMBA), ((B * PROMPT, 7168), None),
                        ((2, 33, 128), None), ((1, 1, 512), None)]:
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
            flops=4 * n, main=main))

    def flash_make(Bq, S, H, K, hd, window):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(0)
            a = {"q": randn(g, (Bq, S, H, hd), dtype), "k": randn(g, (Bq, S, K, hd), dtype),
                 "v": randn(g, (Bq, S, K, hd), dtype), "window": window}
            # library yardstick: SDPA on (B, H, S, hd) with kv heads expanded
            a["lq"] = a["q"].transpose(1, 2)
            a["lk"] = a["k"].repeat_interleave(H // K, dim=2).transpose(1, 2)
            a["lv"] = a["v"].repeat_interleave(H // K, dim=2).transpose(1, 2)
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(S, device=dev)[None, :]
            ok = cols <= rows
            if window is not None:
                ok = ok & (cols > rows - window)
            a["mask"] = None if window is None else ok
            return a
        return make

    for Bq, S, H, K, hd, window, main in [
            (2, 512, 40, 8, 128, None, None), (2, 500, 40, 8, 128, None, None),
            (2, 512, 40, 8, 128, 64, None), (B, PROMPT, 40, 8, 128, None, QWEN),
            (2, 500, 32, 32, 112, None, None), (B, PROMPT, 32, 32, 112, None, ZAMBA),
            # edges: shorter than a q tile, a ragged second tile, hd 64 with G = 8
            (2, 17, 40, 8, 128, None, None), (2, 65, 40, 8, 128, None, None),
            (2, 17, 32, 32, 112, None, None), (2, 65, 32, 32, 112, 64, None),
            (2, 300, 64, 8, 64, None, None), (2, 65, 64, 8, 64, 64, None)]:
        pairs = sum(min(r + 1, window or r + 1) for r in range(S))   # valid (row, col)
        cases.append(dict(
            kernel="flash_attention", desc={"B": Bq, "S": S, "T": S, "H": H, "K": K,
                                            "hd": hd, "causal": True, "window": window},
            make=flash_make(Bq, S, H, K, hd, window),
            run=lambda a: flash_attention_cuda(a["q"], a["k"], a["v"], causal=True,
                                               window=a["window"]),
            plain=lambda a: flash_attention_plain(a["q"], a["k"], a["v"], causal=True,
                                                  window=a["window"]),
            library=lambda a: F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=a["mask"], is_causal=a["mask"] is None),
            nbytes=lambda isz, Bq=Bq, S=S, H=H, K=K, hd=hd: (2 * Bq * S * H * hd
                                                             + 2 * Bq * S * K * hd) * isz,
            flops=4 * Bq * H * hd * pairs, main=main))

    T = PROMPT + GEN
    decode_shapes = [(40, 8, 128, kv_len, window)
                     for kv_len in (1, 37, 300, T) for window in (None, 64)]
    decode_shapes += [(40, 8, 128, PROMPT + GEN // 2, None), (32, 32, 112, 1, None),
                      (32, 32, 112, 300, None), (32, 32, 112, PROMPT + GEN // 2, None),
                      (32, 32, 112, 17, None), (32, 32, 112, T, None), (32, 32, 112, 17, 64)]
    for H, K, hd, kv_len, window in decode_shapes:
        def make(dtype, H=H, K=K, hd=hd, kv_len=kv_len, window=window):
            g = torch.Generator(device=dev).manual_seed(1)
            a = {"q": randn(g, (B, 1, H, hd), dtype), "k": randn(g, (B, T, K, hd), dtype),
                 "v": randn(g, (B, T, K, hd), dtype), "window": window,
                 "kv_len": torch.tensor(kv_len, dtype=torch.int32, device=dev)}
            lo = 0 if window is None else max(0, kv_len - window)
            a["lq"] = a["q"].transpose(1, 2)
            a["lk"] = a["k"][:, lo:kv_len].repeat_interleave(H // K, dim=2).transpose(1, 2)
            a["lv"] = a["v"][:, lo:kv_len].repeat_interleave(H // K, dim=2).transpose(1, 2)
            return a
        valid = kv_len if window is None else min(kv_len, window)
        main = (QWEN if hd == 128 else ZAMBA) if kv_len == PROMPT + GEN // 2 else None
        cases.append(dict(
            kernel="decode_attention",
            desc={"B": B, "T": T, "H": H, "K": K, "hd": hd, "kv_len": kv_len,
                  "window": window},
            make=make,
            run=lambda a: decode_attention_cuda(a["q"], a["k"], a["v"], kv_len=a["kv_len"],
                                                window=a["window"]),
            plain=lambda a: decode_attention_plain(a["q"], a["k"], a["v"],
                                                   kv_len=a["kv_len"], window=a["window"]),
            library=lambda a: F.scaled_dot_product_attention(a["lq"], a["lk"], a["lv"]),
            nbytes=lambda isz, v=valid, H=H, K=K, hd=hd: (2 * B * H * hd
                                                          + 2 * B * v * K * hd) * isz,
            flops=4 * B * H * hd * valid, main=main))

    # ssd_intra_chunk: the sweep of tests/test_kernels.py:68-72 and the
    # zamba2-7b prefill shape (B 8, prompt 512: nc 4, Q 128, H 112, N 64, P 64),
    # once with la = -|N(0,1)| * 0.1 and once with la from the model's range
    # (dt = softplus(N(0,1)), A = -1). In that range L reaches ~-100 over a
    # chunk, where the float32 plain version's own cumsum is off by ~1e-5
    # relative in exp(L_t - L_s); that case, and la = N(0,1) * 0.05 (la > 0
    # in places, exp(L_t - L_s) > 1), are held to the plain version run in
    # float64.
    for (Bs, nc, Q, H, N, P), la_kind, main in [
            ((2, 4, 32, 8, 16, 16), "small", None), ((1, 2, 64, 4, 64, 64), "small", None),
            ((1, 1, 128, 2, 32, 64), "small", None),
            # edges: one mma tile; Q, N and P off the mma tile
            ((1, 1, 16, 1, 8, 8), "small", None), ((1, 2, 40, 3, 4, 12), "small", None),
            # la > 0 in places; P 128 at Q 128, where the kernel runs one slot
            ((1, 2, 40, 3, 4, 12), "mixed", None), ((1, 1, 128, 2, 64, 128), "small", None),
            ((B, PROMPT // 128, 128, 112, 64, 64), "small", ZAMBA),
            ((B, PROMPT // 128, 128, 112, 64, 64), "model", None)]:
        def make(dtype, shape=(Bs, nc, Q, H, N, P), la_kind=la_kind):
            Bs, nc, Q, H, N, P = shape
            g = torch.Generator(device=dev).manual_seed(2)
            z = torch.randn((Bs, nc, Q, H), generator=g, device=dev)
            la = {"small": -z.abs() * 0.1, "model": -F.softplus(z), "mixed": z * 0.05}[la_kind]
            return {"la": la, "C": randn(g, (Bs, nc, Q, N), dtype),
                    "B": randn(g, (Bs, nc, Q, N), dtype),
                    "x": randn(g, (Bs, nc, Q, H, P), dtype)}
        BC, tri = Bs * nc, Q * (Q + 1) // 2
        cases.append(dict(
            kernel="ssd_intra_chunk",
            desc={"B": Bs, "nc": nc, "Q": Q, "H": H, "N": N, "P": P, "la": la_kind},
            make=make, dtypes=("float32",), tols=SSD_TOLS,
            run=lambda a: ssd_intra_chunk_cuda(a["la"], a["C"], a["B"], a["x"]),
            plain=lambda a: ssd_intra_chunk_plain(a["la"], a["C"], a["B"], a["x"]),
            oracle=(lambda a: ssd_intra_chunk_plain(*(a[k].double() for k in "la C B x".split())))
            if la_kind != "small" else None,
            library=None,
            # la, C, B, x read once; y, state, tot written once
            nbytes=lambda isz, BC=BC, Q=Q, H=H, N=N, P=P: isz * (
                BC * Q * H + 2 * BC * Q * N + 2 * BC * Q * H * P + BC * H * P * N + BC * H),
            # On the tensor cores in 3xTF32 (three TF32 products for each
            # float32 one): C.B^T once per (b, chunk) on s <= t; per head
            # M.x on s <= t and the state (w x)^T B. Outside them: per head M
            # on s <= t (difference, exp, product), the end weights, w x.
            flops={"tf32": 3 * (2 * BC * N * tri + BC * H * (2 * P * tri + 2 * Q * P * N)),
                   "float32": BC * H * (3 * tri + 2 * Q + Q * P)},
            main=main))
    return cases


def run_kernel_phase(torch) -> dict:
    """Compare and time every case; return the main-path rows, keyed by
    (kernel, path)."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    main_rows, failures = {}, []
    for case in kernel_cases(torch):
        for dtype_name in case.get("dtypes", ("bfloat16", "float32")):
            a = case["make"](dtypes[dtype_name])
            out = case["run"](a)
            want = (case.get("oracle") or case["plain"])(a)
            torch.cuda.synchronize()
            tols = case.get("tols", (TOL[dtype_name],))
            err, ok = compare(torch, out, want, tols)
            extra = {}
            if case.get("oracle"):
                extra["plain_err_vs_float64"] = compare(torch, case["plain"](a), want, tols)[0]
            isz = 2 if dtype_name == "bfloat16" else 4
            nbytes = case["nbytes"](isz)
            sets = rotating([a] + [case["make"](dtypes[dtype_name])
                                   for _ in range(copies_for(nbytes) - 1)])
            ms = time_ms(torch, lambda: case["run"](sets()))
            dev_ms = device_ms(torch, lambda: case["run"](sets()))
            plain_ms = time_ms(torch, lambda: case["plain"](sets()))
            lib_ms = lib_dev_ms = None
            if case["library"]:
                lib_ms = time_ms(torch, lambda: case["library"](sets()))
                lib_dev_ms = device_ms(torch, lambda: case["library"](sets()))
            bound_ms, bound_by = bound(nbytes, case["flops"], dtype_name)
            bytes_ms, ops_ms = bound_parts(nbytes, case["flops"], dtype_name)
            row = {"phase": "kernel", "kernel": case["kernel"], **case["desc"],
                   "dtype": dtype_name, "max_abs_err": err, "tol": list(tols), "ok": ok,
                   **extra, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms}
            emit(row)
            if not ok:
                failures.append(row)
            if case["main"] and dtype_name == case.get("dtypes", ("bfloat16",))[0]:
                main_rows[(case["kernel"], case["main"])] = row
            del sets, a, out, want
    if failures:
        raise AssertionError(f"{len(failures)} kernel case(s) disagree with the plain version")
    return main_rows


# -- model phases ----------------------------------------------------------------
def expected_launches(cfg, gen: int) -> dict:
    """One prefill and gen - 1 decode steps. Dense: flash L per prefill,
    decode L per step, rmsnorm 2L + 1 layer norms (and 2L qk-norms) per
    forward. Hybrid (ng shared-block sites): flash ng per prefill, decode ng
    per step, rmsnorm 2L + 2ng + 1 per forward, ssd L per prefill."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        ng = L // cfg.shared_attn_every
        return {"rmsnorm": (2 * L + 2 * ng + 1) * gen, "flash_attention": ng,
                "decode_attention": ng * (gen - 1), "ssd_intra_chunk": L}
    return {"rmsnorm": ((2 + 2 * cfg.qk_norm) * L + 1) * gen, "flash_attention": L,
            "decode_attention": L * (gen - 1), "ssd_intra_chunk": 0}


def run_reference_phase(torch, arch: str, n_layers: int, prompt: int) -> None:
    """``arch``'s widths, ``n_layers`` layers, float32, B 2, gen 4: kernels on
    the card against the plain path on the CPU, same weights and prompts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    card = generate(model, params, prompts, 4)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    host = generate(model, cpu_params, prompts.cpu(), 4)
    a, b = card["last_logits"].float().cpu(), host["last_logits"].float()
    rel = float((a - b).abs().max() / b.abs().max())
    same = bool(torch.equal(card["tokens"].cpu(), host["tokens"]))
    emit({"phase": "reference", "cfg": f"{arch} n_layers={n_layers} float32", "B": 2,
          "prompt": prompt, "gen": 4, "logits_rel_err": rel, "tol": 1e-4,
          "tokens_equal": same})
    if not (rel < 1e-4 and same):
        raise AssertionError(f"{arch}: card kernel path disagrees with the CPU plain path")


def check_output(tokens, vocab: int, shape) -> None:
    if tuple(tokens.shape) != shape:
        raise AssertionError(f"generated shape {tuple(tokens.shape)} != {shape}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
        raise AssertionError("generated token outside the (padded) vocabulary")


def check_launches(got: dict, want: dict, phase: str) -> None:
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got} != expected {want}")


def run_staged_phase(torch, arch: str, n_layers: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    t0 = time.perf_counter()
    ops.reset_launches()
    res = serve(cfg, requests=B, prompt_len=PROMPT, gen=GEN, seed=0, device="cuda", log=log)
    got = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not (res["stage_bytes"] == res["published_bytes"]
            and 0 < res["published_bytes"] - res["manifest_bytes"] < 1 << 20):
        raise AssertionError("staged bytes differ from what was published")
    emit({"phase": "staged", "cfg": f"{arch} n_layers={n_layers} bf16", "B": B,
          "prompt": PROMPT, "gen": GEN, "stage_bytes": res["stage_bytes"],
          "manifest_bytes": res["manifest_bytes"],
          "stage_modeled_s": res["stage_modeled_s"], "load_modeled_s": res["load_modeled_s"],
          "generated": list(res["generated"]), "prefill_s": res["prefill_s"],
          "decode_s": res["decode_s"], "wall_s": wall, "launches": got})
    check_launches(got, expected_launches(cfg, GEN), f"staged {arch}")
    return got


def run_full_phase(torch, arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
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
    emit({"phase": "full", "cfg": f"{arch} {cfg.n_layers} layers bf16", "params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s, "B": B, "prompt": PROMPT,
          "gen": GEN, "prefill_ms": res["prefill_s"] * 1e3,
          "decode_ms_per_step": res["decode_s"] / steps * 1e3,
          "decode_tokens_per_s": B * steps / res["decode_s"],
          "tokens_per_s": B * GEN / (res["prefill_s"] + res["decode_s"]),
          "peak_memory_bytes": peak, "launches": got})
    check_launches(got, expected_launches(cfg, GEN), f"full {arch}")
    del params
    return got


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:35", QWEN),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:100", QWEN),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:90", QWEN),
    "ssd_intra_chunk": ("cuda", "src/repro_torch/csrc/ssd_intra_chunk.cu",
                        "src/repro/kernels/ssd_scan.py:68", ZAMBA),
}
TIMES = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
         "library_device_ms")


def kernels_line(main_rows: dict, launches: dict) -> dict:
    """One entry per kernel: launches summed over every staged and full run,
    and the error and times of the main-path shape of ``SOURCES``' path, the
    other path's main shape beside them."""
    rows = []
    for name, (route, source, replaces, path) in SOURCES.items():
        per_run = {run: got[name] for run, got in launches.items()}
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": sum(per_run.values()), "launches_by_run": per_run,
                     "shape_path": path, **{k: main_rows[(name, path)][k] for k in TIMES},
                     "other_paths": {p: {k: row[k] for k in TIMES}
                                     for (n, p), row in main_rows.items()
                                     if n == name and p != path}})
    return {"kernels": rows}


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
    t_start = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "sources": sorted(built), "seconds": time.perf_counter() - t_start})

    main_rows = run_kernel_phase(torch)
    run_reference_phase(torch, QWEN, 2, 32)
    run_reference_phase(torch, ZAMBA, 7, 160)
    launches = {}
    for arch, staged_layers in ((QWEN, 2), (ZAMBA, 7)):
        torch.cuda.empty_cache()
        launches[f"staged {arch}"] = run_staged_phase(torch, arch, staged_layers)
        torch.cuda.empty_cache()
        launches[f"full {arch}"] = run_full_phase(torch, arch)

    emit(kernels_line(main_rows, launches))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
