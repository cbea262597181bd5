#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each printing one JSON line to stdout:

  build      compile every CUDA source with nvcc (one process each, in parallel)
  kernel     each kernel against its plain PyTorch version on the card, at the
             shapes the qwen3-14b and zamba2-7b serving paths and the
             phi4-mini-3.8b training path give it: bf16 (tolerance 2e-2) and
             float32 (2e-5, TF32 off); ssd_intra_chunk float32 only, 2e-4 on y
             and state and 1e-5 on tot; the backward kernels (flash_attention_bwd,
             rmsnorm_bwd) at 2e-2 (bf16) and 1e-4 (float32) of each output's
             max|grad|. Kernel, plain and one-PyTorch-call (``library_ms``, a
             yardstick the port never calls; autograd through it for a
             backward) times
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
  train ref  phi4-mini-3.8b widths with 2 layers, float32, B 2, S 200: loss and
             every grad leaf of the card's kernel path against the CPU plain
             path (1e-4, 1e-4 of max|g|), then one train step on each (params
             within 1e-5 of their max)
  train staged  ``repro_torch.launch.train.train`` on the smoke phi4-mini-3.8b
             (head dim 64, the kernels' smallest): corpus staged into the burst
             tier, 6 steps, checkpoints saved and drained, held batch improved
  train full phi4-mini-3.8b at full width, 8 of 32 layers, bf16 params and fp32
             AdamW state, B 4, S 2048, remat "full": a warm-up step, then 5
             timed steps on Loader batches
  kernels    per kernel: launches in every staged, full and training run,
             error, times, bound; each run's launch counts must equal what its
             path implies

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
# backward kernels, as a share of each output's max|grad|: bf16 as
# tests/test_kernels.py:22; float32 looser than 2e-5 because dq is summed by
# float32 atomics in no fixed order
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_TOLS = (2e-4, 2e-4, 1e-5)      # y, state, tot (tests/test_kernels.py:81-83)
B, PROMPT, GEN = 8, 512, 32
QWEN, ZAMBA, PHI = "qwen3-14b", "zamba2-7b", "phi4-mini-3.8b"
TRAIN_B, TRAIN_S, TRAIN_LAYERS, TRAIN_STEPS = 4, 2048, 8, 5


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


def compare_grads(torch, out, want, tol: float) -> tuple[float, bool]:
    """Largest error over the outputs, each as a share of its own max|want|,
    and whether every share is within ``tol``."""
    worst = 0.0
    for o, w in zip(out, want):
        if not torch.isfinite(o.float()).all():
            return float("nan"), False
        scale = max(float(w.float().abs().max()), 1e-30)
        worst = max(worst, float((o.float() - w.float()).abs().max()) / scale)
    return worst, worst <= tol


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
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
        flash_attention_lse_plain, flash_attention_plain)
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd_plain, rmsnorm_bwd_triton, rmsnorm_plain, rmsnorm_triton)
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_cuda, ssd_intra_chunk_plain
    F = torch.nn.functional
    dev = torch.device("cuda")
    cases = []

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for shape, main in [((B * PROMPT, 5120), QWEN), ((B * PROMPT * 40, 128), None),
                        ((B * PROMPT, 3584), ZAMBA), ((B * PROMPT, 7168), None),
                        ((TRAIN_B * TRAIN_S, 3072), PHI),
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

    def flash_fwd(a):
        out = flash_attention_cuda(a["q"], a["k"], a["v"], causal=True, window=a["window"],
                                   return_lse=a["lse"])
        return out[0] if a["lse"] else out

    def flash_make(Bq, S, H, K, hd, window, lse):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(0)
            a = {"q": randn(g, (Bq, S, H, hd), dtype), "k": randn(g, (Bq, S, K, hd), dtype),
                 "v": randn(g, (Bq, S, K, hd), dtype), "window": window, "lse": lse}
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
            (TRAIN_B, TRAIN_S, 24, 8, 128, None, PHI),
            (2, 512, 40, 8, 128, None, None), (2, 500, 40, 8, 128, None, None),
            (2, 512, 40, 8, 128, 64, None), (B, PROMPT, 40, 8, 128, None, QWEN),
            (2, 500, 32, 32, 112, None, None), (B, PROMPT, 32, 32, 112, None, ZAMBA),
            # edges: shorter than a q tile, a ragged second tile, hd 64 with G = 8
            (2, 17, 40, 8, 128, None, None), (2, 65, 40, 8, 128, None, None),
            (2, 17, 32, 32, 112, None, None), (2, 65, 32, 32, 112, 64, None),
            (2, 300, 64, 8, 64, None, None), (2, 65, 64, 8, 64, 64, None)]:
        pairs = sum(min(r + 1, window or r + 1) for r in range(S))   # valid (row, col)
        lse = main == PHI              # training writes each row's lse for the backward
        cases.append(dict(
            kernel="flash_attention", desc={"B": Bq, "S": S, "T": S, "H": H, "K": K,
                                            "hd": hd, "causal": True, "window": window,
                                            "lse": lse},
            make=flash_make(Bq, S, H, K, hd, window, lse),
            run=lambda a: flash_fwd(a),
            plain=lambda a: flash_attention_plain(a["q"], a["k"], a["v"], causal=True,
                                                  window=a["window"]),
            library=lambda a: F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=a["mask"], is_causal=a["mask"] is None),
            nbytes=lambda isz, Bq=Bq, S=S, H=H, K=K, hd=hd, lse=lse: (
                2 * Bq * S * H * hd + 2 * Bq * S * K * hd) * isz + 4 * Bq * H * S * lse,
            flops=4 * Bq * H * hd * pairs, main=main))

    # backward kernels: the phi4-mini-3.8b training shapes, then a window, a
    # ragged S, hd 112 (zamba2's shared block, MHA), hd 64 with G = 4, and a
    # second 128-key tile holding one key under a window shorter than a tile
    def flash_bwd_make(Bq, S, H, K, hd, window):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(4)
            a = {"q": randn(g, (Bq, S, H, hd), dtype), "k": randn(g, (Bq, S, K, hd), dtype),
                 "v": randn(g, (Bq, S, K, hd), dtype), "do": randn(g, (Bq, S, H, hd), dtype),
                 "window": window}
            # o and lse from the forward kernel (uncounted), its lse checked
            a["o"], a["lse"] = flash_attention_cuda(a["q"], a["k"], a["v"], window=window,
                                                    return_lse=True)
            want = flash_attention_lse_plain(a["q"], a["k"], window=window)
            a["lse_err"] = float((a["lse"] - want).abs().max() / want.abs().max())
            # library yardstick: autograd through SDPA (GQA), its forward done here
            a["lq"], a["lk"], a["lv"] = (t.transpose(1, 2).detach().requires_grad_()
                                         for t in (a["q"], a["k"], a["v"]))
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(S, device=dev)[None, :]
            mask = None if window is None else (cols <= rows) & (cols > rows - window)
            a["lout"] = F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            a["ldo"] = a["do"].transpose(1, 2)
            return a
        return make

    for Bq, S, H, K, hd, window, main in [
            (TRAIN_B, TRAIN_S, 24, 8, 128, None, PHI), (2, 1024, 24, 8, 128, 256, None),
            (2, 1000, 24, 8, 128, None, None), (2, 512, 32, 32, 112, None, None),
            (2, 300, 16, 4, 64, None, None), (2, 65, 24, 8, 128, 64, None),
            (2, 129, 24, 8, 128, 64, None)]:
        pairs = sum(min(r + 1, window or r + 1) for r in range(S))
        cases.append(dict(
            kernel="flash_attention_bwd",
            desc={"B": Bq, "S": S, "T": S, "H": H, "K": K, "hd": hd, "causal": True,
                  "window": window},
            make=flash_bwd_make(Bq, S, H, K, hd, window), grads=True,
            run=lambda a: flash_attention_bwd_cuda(a["q"], a["k"], a["v"], a["o"], a["lse"],
                                                   a["do"], window=a["window"]),
            plain=lambda a: flash_attention_bwd_plain(a["q"], a["k"], a["v"], a["o"], a["lse"],
                                                      a["do"], window=a["window"]),
            library=lambda a: torch.autograd.grad(a["lout"], (a["lq"], a["lk"], a["lv"]),
                                                  a["ldo"], retain_graph=True),
            # q, o, dO and dq (H heads), k, v, dk and dv (K heads); lse
            nbytes=lambda isz, Bq=Bq, S=S, H=H, K=K, hd=hd: (4 * Bq * S * H * hd
                                                             + 4 * Bq * S * K * hd) * isz
            + 4 * Bq * H * S,
            # 2.5 times the causal forward's: S, dP, dV, dK, dQ
            flops=10 * Bq * H * hd * pairs, main=main))

    def rms_bwd_make(shape):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(5)
            a = {"x": randn(g, shape, dtype), "scale": randn(g, shape[-1:], dtype),
                 "g": randn(g, shape, dtype)}
            _, a["inv"] = rmsnorm_triton(a["x"], a["scale"], return_inv=True)
            a["lx"] = a["x"].detach().requires_grad_()
            a["ls"] = a["scale"].detach().requires_grad_()
            a["lout"] = F.rms_norm(a["lx"], shape[-1:], a["ls"], 1e-5)
            return a
        return make

    for shape, main in [((TRAIN_B * TRAIN_S, 3072), PHI), ((B * PROMPT * 40, 128), None),
                        ((B * PROMPT, 5120), None), ((2, 33, 3072), None)]:
        n = math.prod(shape)
        cases.append(dict(
            kernel="rmsnorm_bwd", desc={"shape": list(shape)}, make=rms_bwd_make(shape),
            grads=True,
            run=lambda a: rmsnorm_bwd_triton(a["x"], a["scale"], a["g"], a["inv"]),
            plain=lambda a: rmsnorm_bwd_plain(a["x"], a["scale"], a["g"]),
            library=lambda a: torch.autograd.grad(a["lout"], (a["lx"], a["ls"]), a["g"],
                                                  retain_graph=True),
            # x and g read, dx written, inv read; scale read and dscale written
            nbytes=lambda isz, n=n, d=shape[-1]: 3 * n * isz + 4 * (n // d) + 2 * d * isz,
            flops=8 * n, main=main))

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
            if case.get("grads"):
                tols = (GRAD_TOL[dtype_name],)
                err, ok = compare_grads(torch, out, want, tols[0])
            else:
                tols = case.get("tols", (TOL[dtype_name],))
                err, ok = compare(torch, out, want, tols)
            extra = {"lse_rel_err": a["lse_err"]} if "lse_err" in a else {}
            if "lse_err" in a and not a["lse_err"] < 1e-5:
                ok = False
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
    bwd = {"rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    if cfg.family == "hybrid":
        ng = L // cfg.shared_attn_every
        return {"rmsnorm": (2 * L + 2 * ng + 1) * gen, "flash_attention": ng,
                "decode_attention": ng * (gen - 1), "ssd_intra_chunk": L, **bwd}
    return {"rmsnorm": ((2 + 2 * cfg.qk_norm) * L + 1) * gen, "flash_attention": L,
            "decode_attention": L * (gen - 1), "ssd_intra_chunk": 0, **bwd}


def expected_train_launches(cfg, steps: int, evals: int, remat: bool) -> dict:
    """``steps`` train steps and ``evals`` no-grad loss evaluations of a dense
    model: a step runs each layer's forward once, and once more in the
    backward under remat "full", then the backward; norms per layer 2 (and 2
    qk-norms), plus the final norm, outside the remat."""
    L, n = cfg.n_layers, 2 + 2 * cfg.qk_norm
    fwd = 2 if remat else 1
    return {"rmsnorm": steps * (n * L * fwd + 1) + evals * (n * L + 1),
            "flash_attention": steps * L * fwd + evals * L, "decode_attention": 0,
            "ssd_intra_chunk": 0, "rmsnorm_bwd": steps * (n * L + 1),
            "flash_attention_bwd": steps * L}


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


# -- training phases ---------------------------------------------------------------
def _rel_to_max(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def run_train_reference_phase(torch, n_layers: int = 2) -> dict:
    """phi4-mini-3.8b widths, ``n_layers`` layers, float32, B 2, S 200 (ragged
    tiles): the card's kernel path (remat "full") against the CPU plain path,
    same weights and batch: the loss within 1e-4 and every grad leaf within
    1e-4 of its max|g|; AdamW applied to the same grads (the card's) on each
    side, the updated params within 1e-5 of their max; then one train step
    on each side, its loss equal to the first.

    Each side's own train step is not held to 1e-5: AdamW's first update is
    lr * g / (|g| + eps), lr * sign(g) wherever |g| >> eps, so a grad entry
    within float32 rounding of zero takes opposite signs on the two sides
    and moves by 2 lr. That gap is reported, not checked."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import (RuntimeConfig, TrainState, loss_and_grads,
                                     make_train_step)
    cfg = dataclasses.replace(get_config(PHI), n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", schedule="constant", opt=optim.AdamWConfig(lr=1e-3))
    step = make_train_step(model, rt)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = tree_map(lambda t: t.to("cpu", copy=True), params)   # stepped in place
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 201), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    sides = {}
    ops.reset_launches()
    for side in ("card", "cpu"):
        if side == "cpu":
            launches = dict(ops.LAUNCHES)
            params = cpu_params
            batch = {k: v.cpu() for k, v in batch.items()}
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, params, batch, remat=rt.remat)
        grads = tree_map(lambda t: t.cpu(), grads)
        if side == "card":
            card_grads = grads
        else:
            grad_err = max(_rel_to_max(torch, a, b)
                           for a, b in zip(leaves(card_grads), leaves(grads)))
        same = tree_map(lambda t: t.to(params["embed"]["w"].device), card_grads)
        del grads
        upd = tree_map(lambda t: t.detach().clone(), params)
        upd, _, _ = optim.update(same, optim.init(upd), upd, rt.opt)
        updated = [t.cpu() for t in leaves(upd)]
        del upd, same
        state, metrics = step(TrainState(params, optim.init(params), ()), batch)
        if side == "card":
            torch.cuda.synchronize()
        sides[side] = {"loss": float(loss), "step_loss": float(metrics["loss"]),
                       "updated": updated,
                       "stepped": [t.detach().cpu() for t in leaves(state.params)],
                       "s": time.perf_counter() - t0}
        del state
    card, cpu = sides["card"], sides["cpu"]
    param_err = max(_rel_to_max(torch, a, b) for a, b in zip(card["updated"], cpu["updated"]))
    own_err = max(_rel_to_max(torch, a, b) for a, b in zip(card["stepped"], cpu["stepped"]))
    loss_err = abs(card["loss"] - cpu["loss"])
    row = {"phase": "train reference", "cfg": f"{PHI} n_layers={n_layers} float32",
           "B": 2, "S": 200, "loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss_abs_err": loss_err, "loss_tol": 1e-4, "grad_err_of_max": grad_err,
           "grad_tol": 1e-4, "param_err_of_max_same_grads": param_err, "param_tol": 1e-5,
           "param_err_of_max_own_steps": own_err, "lr": rt.opt.lr,
           "card_s": card["s"], "cpu_s": cpu["s"], "launches": launches}
    emit(row)
    if not (loss_err < 1e-4 and grad_err < 1e-4 and param_err < 1e-5
            and card["step_loss"] == card["loss"] and cpu["step_loss"] == cpu["loss"]):
        raise AssertionError("train reference: the card's kernel path disagrees with the "
                             "CPU plain path")
    check_launches(launches, {k: 2 * v for k, v in
                              expected_train_launches(cfg, 1, 0, True).items()},
                   "train reference")
    return launches


def run_train_staged_phase(torch) -> dict:
    """``launch.train.train`` end to end on the card on the smoke phi4-mini
    with head dim 64: corpus staged, 6 steps, checkpoints at 3 and 6 saved to
    the burst tier and drained, the held batch improved."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_smoke(PHI), head_dim=64)
    steps = 6
    ops.reset_launches()
    res = train(cfg, steps=steps, batch=4, seq=128, lr=1e-3, ckpt_every=3, seed=0,
                device="cuda", log=log)
    got = dict(ops.LAUNCHES)
    emit({"phase": "train staged", "cfg": f"{cfg.name} head_dim=64", "B": 4, "S": 128,
          "steps": steps, "losses": res["losses"], "eval_before": res["eval_before"],
          "eval_after": res["eval_after"], "improved": res["improved"],
          "committed": res["steps"], "drains": res["drains"],
          "stage_bytes": res["stage_bytes"], "wall_s": res["wall_s"], "launches": got})
    if not (res["improved"] and res["steps"] and len(res["drains"]) == 2
            and all(math.isfinite(x) for x in res["losses"])):
        raise AssertionError("train staged: no improvement or no committed, drained step")
    check_launches(got, expected_train_launches(cfg, steps, 2, True), "train staged")
    return got


def run_train_full_phase(torch) -> dict:
    """phi4-mini-3.8b at full width, TRAIN_LAYERS of 32 layers, bf16 params,
    fp32 AdamW state, B 4, S 2048, remat "full": one warm-up step, then
    TRAIN_STEPS timed steps on Loader batches."""
    from repro_torch.configs import get_config
    from repro_torch.data import DatasetSpec, Loader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import RuntimeConfig, make_train_state, make_train_step
    cfg = dataclasses.replace(get_config(PHI), n_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", opt=AdamWConfig(lr=1e-4), schedule="constant")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), rt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    loader = Loader(DatasetSpec(seed=7, vocab=cfg.vocab_size, n_tokens=1 << 24),
                    batch=TRAIN_B, seq=TRAIN_S)
    step = make_train_step(model, rt)
    state, _ = step(state, to_device(loader.batch_at(0), dev))          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for i in range(1, TRAIN_STEPS + 1):
        batch = to_device(loader.batch_at(i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "step_ms": dt * 1e3, "tokens_per_s": TRAIN_B * TRAIN_S / dt,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    got = dict(ops.LAUNCHES)
    mean_ms = sum(x["step_ms"] for x in steps) / len(steps)
    emit({"phase": "train full", "cfg": f"{PHI} {TRAIN_LAYERS} of 32 layers bf16, fp32 AdamW",
          "params": n_params, "init_s": init_s, "B": TRAIN_B, "S": TRAIN_S,
          "remat": rt.remat, "steps": steps, "mean_step_ms": mean_ms,
          "mean_tokens_per_s": TRAIN_B * TRAIN_S / mean_ms * 1e3, "launches": got})
    if not all(math.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in steps):
        raise AssertionError("train full: a non-finite loss or a zero grad norm")
    check_launches(got, expected_train_launches(cfg, TRAIN_STEPS, 0, True), "train full")
    del state
    return got


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# the backward kernels have no TPU counterpart: "replaces" names the TPU
# kernel (or, for rmsnorm, repro's custom VJP) whose gradient they compute
SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:35", QWEN),
    "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/models/layers.py:68", PHI),
    "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:100", PHI),
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
    """One entry per kernel: launches summed over every staged, full and training run,
    and the error and times of the main-path shape of ``SOURCES``' path, the
    other path's main shape beside them."""
    rows = []
    for name, (route, source, replaces, path) in SOURCES.items():
        per_run = {run: got[name] for run, got in launches.items()}
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     **({"note": "backward: the TPU kernel has none"}
                        if name.endswith("_bwd") else {}),
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
    log(f"chip_smoke: kernel phase done at {time.perf_counter() - t_start:.1f} s")
    run_reference_phase(torch, QWEN, 2, 32)
    run_reference_phase(torch, ZAMBA, 7, 160)
    launches = {}
    for arch, staged_layers in ((QWEN, 2), (ZAMBA, 7)):
        torch.cuda.empty_cache()
        launches[f"staged {arch}"] = run_staged_phase(torch, arch, staged_layers)
        torch.cuda.empty_cache()
        launches[f"full {arch}"] = run_full_phase(torch, arch)
    log(f"chip_smoke: serving phases done at {time.perf_counter() - t_start:.1f} s")
    for name, phase in (("train reference", run_train_reference_phase),
                        ("train staged", run_train_staged_phase),
                        ("train full", run_train_full_phase)):
        torch.cuda.empty_cache()
        launches[name] = phase(torch)
        log(f"chip_smoke: {name} done at {time.perf_counter() - t_start:.1f} s")

    emit(kernels_line(main_rows, launches))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
