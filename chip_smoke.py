#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each printing one JSON line to stdout:

  build      compile every CUDA source with nvcc (one process each, in parallel)
  kernel     each kernel against its plain PyTorch version on the card, at the
             shapes the qwen3-14b, zamba2-7b, qwen3-moe-30b-a3b, gemma3-12b
             (hd 256: local layers' window 1024 and the ring, global layers),
             internvl2-2b, xlstm-1.3b (its norms) and whisper-tiny (the
             encoder's non-causal attention over 1500 frames, the
             cross-attention's 416 or 448 queries against 1500 keys, decode
             over the 1500 keys; the decode kernel's per-row lse at
             qwen3-14b's and gemma3's global shapes) serving paths and the phi4-mini-3.8b and
             granite-moe-1b-a400m, gemma3-12b (hd 256, window 1024), zamba2-7b,
             xlstm-1.3b and whisper-tiny training paths give it: bf16 (tolerance 2e-2) and
             float32 (2e-5, TF32 off); ssd_intra_chunk float32 only, 2e-4 on y
             and state and 1e-5 on tot; the backward kernels (flash_attention_bwd,
             rmsnorm_bwd, ssd_intra_chunk_bwd) at 2e-2 (bf16) and 1e-4 (float32)
             of each output's max|grad|, ssd_intra_chunk_bwd against its plain
             version in float64. Kernel, plain and one-PyTorch-call (``library_ms``, a
             yardstick the port never calls; autograd through it for a
             backward) times, inputs and outputs rotated over copies so
             that no call finds the last one's data in L2
  reference  card kernel path against the CPU plain path, same weights:
             qwen3-14b widths with 2 layers, zamba2-7b widths with 7 layers
             (a group of 6 and a tail of 1), float32; qwen3-moe-30b-a3b widths
             with 2 layers, float32, held per routing call (router logits,
             and the experts fed the same routing on both sides) and on the
             rows whose routes agree (``run_moe_reference_phase``);
             gemma3-12b widths with 6 layers (one block of 5 local and 1
             global) and a 1030-token prompt, longer than the 1024-slot ring
             and out of step with it; internvl2-2b widths with 2 layers and
             seeded patch embeddings; xlstm-1.3b widths with 8 layers (one
             block) and a 160-token prompt (two chunks, the second padded);
             whisper-tiny with all 4 + 4 layers and 1500 seeded frames
  staged     ``repro_torch.launch.serve.serve`` publish -> stage through the
             burst tier -> restore -> prefill 8 x 512 (gemma3 8 x 1536) ->
             decode 32 tokens:
             qwen3-14b with 2 layers (~4.4 GB staged), zamba2-7b with 7
             layers (~2.0 GB), qwen3-moe-30b-a3b with 2 layers (~3.7 GB),
             gemma3-12b with 6 layers and prompt 1536 (the ring wraps),
             internvl2-2b with 2 layers and 256 seeded patch embeddings,
             xlstm-1.3b with 8 layers, whisper-tiny with all its layers,
             prompt 416 and 1500 zero frames
  full       qwen3-14b (40 layers), zamba2-7b (81 layers), qwen3-moe-30b-a3b
             (48 layers, ~61 GB), gemma3-12b (48 layers, ~23.5 GB, prompt
             1536), internvl2-2b (24 layers, 256 patches + prompt 512),
             xlstm-1.3b (48 layers, 3.73 G parameters) and whisper-tiny (4 + 4
             layers, 1500 zero frames, prompt 416),
             bf16, weights from a seeded generator on the card, no staging:
             the same batch, timed
  train ref  phi4-mini-3.8b and granite-moe-1b-a400m widths with 2 layers,
             float32, B 2, S 200: loss and every grad leaf of the card's kernel
             path against the CPU plain path (1e-4, 1e-4 of max|g|), then one
             train step on each (params within 1e-5 of their max); for MoE
             the CPU side takes the card's expert ids, its router held on
             the card's input to each call (1e-5 of max|logit|). gemma3-12b
             widths with 6 layers (a block of 5 local and 1 global), B 1,
             S 200 over a window cut to 128 so that it bites at that S, and
             zamba2-7b widths with 7 layers (a group of 6 and the shared
             block, a tail of 1), B 1, S 200 (two chunks, the second padded):
             loss and grads only (AdamW is the same code as phi4-mini's), for
             the CPU side's time and memory at vocab 262,144; zamba2's card
             held to the CPU plain path in float64, float32 reported beside;
             xlstm-1.3b widths with 8 layers (one block), B 1, S 200, loss and
             grads; whisper-tiny with all layers and seeded frames, B 2, S 200,
             with AdamW
  train staged  ``repro_torch.launch.train.train`` on the smoke phi4-mini-3.8b,
             granite-moe-1b-a400m, gemma3-12b, zamba2-7b, xlstm-1.3b and
             whisper-tiny (head dim 64, the
             kernels' smallest): corpus staged into the burst tier, 6 steps,
             checkpoints saved and drained, held batch improved
  train full phi4-mini-3.8b (8 of 32 layers), granite-moe-1b-a400m (all 24
             layers), gemma3-12b (6 of 48: one block of 5 local and 1 global)
             and zamba2-7b (14 of 81: two groups of 6 with the shared block,
             a tail of 2), xlstm-1.3b (16 of 48: two blocks of 1 sLSTM and 7
             mLSTM) at full width, bf16 params and fp32 AdamW state, B 4,
             S 2048, and whisper-tiny (all layers, zero frames) at B 4, S 448,
             remat "full": a warm-up step, then 5 timed steps on Loader
             batches
  cost       the dry-run (``repro_torch.launch.dryrun``, in a child process on
             CPU fakes, a fake world of 1, started at the outset) of the train
             full phase's phi4-mini-3.8b (8 layers) and gemma3-12b (6 layers)
             at B 4, S 2048, remat "full", beside that phase's mean step and
             peak memory: the predicted peak (argument + temp bytes) within
             20% of ``max_memory_allocated``, and no step faster than its
             ``compute_s`` (the step's counted flops at the bf16 peak); the
             model flops' share of that peak in the step is printed as a
             reading, not a gate
  mesh       the mesh steps (``runtime.parallel.shard_*``) on an NCCL
             world of 1 in this process, mesh (data 1, model 1), everything a
             DTensor and the kernels on local shards: qwen3-14b at all 40
             layers served (B 8, prompt 512, 32 greedy tokens) and
             phi4-mini-3.8b (8 of 32 layers, B 4, S 2048, bf16 params, fp32
             AdamW, ZeRO-1, remat "full") trained 3 steps, each beside the
             same run through the one-device steps: tokens equal, losses
             within 1e-3, the kernels' launches equal; the times side by side
  kernels    per kernel: launches in every staged, full, training and mesh
             run, error, times, bound; each run's launch counts must equal
             what its path implies (MoE launches the same kernels as dense)

Then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# backward kernels, as a share of each output's max|grad|: bf16 as
# tests/test_kernels.py:22; float32 looser than 2e-5 because dq is summed by
# float32 atomics in no fixed order
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_TOLS = (2e-4, 2e-4, 1e-5)      # y, state, tot (tests/test_kernels.py:81-83)
B, PROMPT, GEN = 8, 512, 32
QWEN, ZAMBA, PHI = "qwen3-14b", "zamba2-7b", "phi4-mini-3.8b"
QMOE, GRAN = "qwen3-moe-30b-a3b", "granite-moe-1b-a400m"
GEM, INTERN = "gemma3-12b", "internvl2-2b"
XL, WH = "xlstm-1.3b", "whisper-tiny"
GEM_LOCAL = GEM + " local"                 # gemma3's local layers' kernel shapes
QWEN_LSE = QWEN + " lse"                   # the decode kernel with its lse output
# whisper's attention and xlstm's norms: each its own kernel shape
WH_ENC, WH_CROSS = WH + " encoder", WH + " cross"
XL_INNER = XL + " d_inner"
# prompt tokens served (before internvl2's 256 patch embeddings): gemma3's
# 1536 is longer than its 1024-slot ring and out of step with it; whisper's
# 416 and 32 generated fill its 448-token text context
SERVE_PROMPT = {GEM: 1536, WH: 416}
WH_FRAMES = 1500                           # whisper-tiny's encoder_seq
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5
# phi4-mini cut to 8 of 32; granite at full depth; gemma3 to one block (6 of
# 48); zamba2 to two groups and a tail (14 of 81); xlstm to two blocks (16 of
# 48); whisper at full depth (4 + 4)
TRAIN_LAYERS = {PHI: 8, GRAN: 24, GEM: 6, ZAMBA: 14, XL: 16, WH: 4}
TRAIN_SEQ = {WH: 448}                      # whisper's text context
GEM_TRAIN_LOCAL = GEM + " train local"     # gemma3's local layers' training shapes
WH_TRAIN_ENC, WH_TRAIN_CROSS = WH + " train encoder", WH + " train cross"
XL_TRAIN, XL_TRAIN_INNER = XL + " train", XL + " train d_inner"


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
    """``run(fn)`` calls ``fn`` on the next of the input copies in turn, so a
    timed kernel does not find its inputs in the 50 MB L2 from an earlier
    call. Each call's output is kept for as many calls as there are copies,
    so the allocator does not hand the next call the block the last one
    wrote, whose dirty lines would still be in L2."""
    state = {"i": 0}
    kept = collections.deque(maxlen=len(sets))

    def run(fn):
        kept.append(fn(sets[state["i"] % len(sets)]))
        state["i"] += 1
    return run


def copies_for(nbytes: int) -> int:
    return max(1, min(8, math.ceil(128e6 / max(nbytes, 1))))


def bound_parts(nbytes: float, flops, dtype: str) -> tuple[float, float]:
    """Least ms for the bytes at the HBM rate and for the flops at the peak
    (``core.perfmodel.H100``): ``flops`` is a count at ``dtype``'s peak, or
    ``{rate: count}`` for work that runs at several ("bfloat16" and "tf32"
    on the tensor cores, "float32" outside them)."""
    from repro_torch.core.perfmodel import H100
    peak = {"bfloat16": H100.peak_flops_bf16, "tf32": H100.peak_flops_tf32,
            "float32": H100.peak_flops_fp32}
    work = flops if isinstance(flops, dict) else {dtype: flops}
    return (nbytes / H100.hbm_bw * 1e3, sum(n / peak[k] for k, n in work.items()) * 1e3)


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
    from repro_torch.kernels.ssd_scan import (
        ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_bwd_plain, ssd_intra_chunk_cuda,
        ssd_intra_chunk_plain)
    F = torch.nn.functional
    dev = torch.device("cuda")
    cases = []

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for shape, main in [((B * PROMPT, 5120), QWEN), ((B * PROMPT * 40, 128), None),
                        ((B * PROMPT, 3584), ZAMBA), ((B * PROMPT, 7168), None),
                        ((TRAIN_B * TRAIN_S, 3072), PHI), ((B * PROMPT, 2048), QMOE),
                        ((TRAIN_B * TRAIN_S, 1024), GRAN), ((B * 1536, 3840), GEM),
                        ((2, 33, 128), None), ((1, 1, 512), None),
                        # xlstm's residual and d_inner norms, serving and
                        # training; whisper's encoder
                        ((B * PROMPT, 2048), XL), ((B * PROMPT, 4096), XL_INNER),
                        ((TRAIN_B * TRAIN_S, 2048), XL_TRAIN),
                        ((TRAIN_B * TRAIN_S, 4096), XL_TRAIN_INNER),
                        ((B * WH_FRAMES, 384), WH)]:
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
        out = flash_attention_cuda(a["q"], a["k"], a["v"], causal=a["causal"],
                                   window=a["window"], return_lse=a["lse"])
        return out[0] if a["lse"] else out

    def flash_make(Bq, S, T, H, K, hd, window, lse, causal):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(0)
            a = {"q": randn(g, (Bq, S, H, hd), dtype), "k": randn(g, (Bq, T, K, hd), dtype),
                 "v": randn(g, (Bq, T, K, hd), dtype), "window": window, "lse": lse,
                 "causal": causal}
            # library yardstick: SDPA on (B, H, S, hd) with kv heads expanded
            a["lq"] = a["q"].transpose(1, 2)
            a["lk"] = a["k"].repeat_interleave(H // K, dim=2).transpose(1, 2)
            a["lv"] = a["v"].repeat_interleave(H // K, dim=2).transpose(1, 2)
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(T, device=dev)[None, :]
            ok = cols <= rows
            if window is not None:
                ok = ok & (cols > rows - window)
            a["mask"] = None if window is None else ok
            return a
        return make

    # (B, S, T, H, K, hd, window, causal, lse, main): S = T and causal, lse
    # where training writes it for the backward, unless listed otherwise
    flash_fwd_cases = [(Bq, S, S, H, K, hd, window, True, main in (PHI, GRAN), main)
                       for Bq, S, H, K, hd, window, main in [
            (TRAIN_B, TRAIN_S, 24, 8, 128, None, PHI),
            (2, 512, 40, 8, 128, None, None), (2, 500, 40, 8, 128, None, None),
            (2, 512, 40, 8, 128, 64, None), (B, PROMPT, 40, 8, 128, None, QWEN),
            (2, 500, 32, 32, 112, None, None), (B, PROMPT, 32, 32, 112, None, ZAMBA),
            # edges: shorter than a q tile, a ragged second tile, hd 64 with G = 8
            (2, 17, 40, 8, 128, None, None), (2, 65, 40, 8, 128, None, None),
            (2, 17, 32, 32, 112, None, None), (2, 65, 32, 32, 112, 64, None),
            (2, 300, 64, 8, 64, None, None), (2, 65, 64, 8, 64, 64, None),
            # qwen3-moe prefill (G 8) and granite training (hd 64, G 2)
            (B, PROMPT, 32, 4, 128, None, QMOE), (TRAIN_B, TRAIN_S, 16, 8, 64, None, GRAN),
            # gemma3 prefill, hd 256: local layers (window 1024) and global
            # ones; a ragged edge under a short window; internvl2's prefill
            # (256 patches + 512 tokens)
            (B, 1536, 16, 8, 256, 1024, GEM_LOCAL), (B, 1536, 16, 8, 256, None, GEM),
            (2, 1000, 16, 8, 256, 100, None), (B, PROMPT + 256, 16, 8, 128, None, INTERN)]]
    # whisper-tiny (6 heads of 64): the encoder (non-causal, S = T = 1500),
    # the decoder's cross-attention (non-causal, prompt 416 against 1500
    # keys) and self-attention (causal) when serving; the encoder and the
    # cross-attention when training (S 448, lse written); ragged S and T
    flash_fwd_cases += [
        (B, WH_FRAMES, WH_FRAMES, 6, 6, 64, None, False, False, WH_ENC),
        (B, 416, WH_FRAMES, 6, 6, 64, None, False, False, WH_CROSS),
        (B, 416, 416, 6, 6, 64, None, True, False, WH),
        (TRAIN_B, WH_FRAMES, WH_FRAMES, 6, 6, 64, None, False, True, WH_TRAIN_ENC),
        (TRAIN_B, 448, WH_FRAMES, 6, 6, 64, None, False, True, WH_TRAIN_CROSS),
        (2, 129, 257, 6, 3, 64, None, False, True, None)]
    for Bq, S, T, H, K, hd, window, causal, lse, main in flash_fwd_cases:
        # valid (row, col) pairs
        pairs = sum(min(r + 1, window or r + 1) for r in range(S)) if causal else S * T
        cases.append(dict(
            kernel="flash_attention", desc={"B": Bq, "S": S, "T": T, "H": H, "K": K,
                                            "hd": hd, "causal": causal, "window": window,
                                            "lse": lse},
            make=flash_make(Bq, S, T, H, K, hd, window, lse, causal),
            run=lambda a: flash_fwd(a),
            plain=lambda a: flash_attention_plain(a["q"], a["k"], a["v"], causal=a["causal"],
                                                  window=a["window"]),
            library=lambda a: F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=a["mask"],
                is_causal=a["mask"] is None and a["causal"]),
            nbytes=lambda isz, Bq=Bq, S=S, T=T, H=H, K=K, hd=hd, lse=lse: (
                2 * Bq * S * H * hd + 2 * Bq * T * K * hd) * isz + 4 * Bq * H * S * lse,
            flops=4 * Bq * H * hd * pairs, main=main))

    # backward kernels: the phi4-mini-3.8b training shapes, then a window, a
    # ragged S, hd 112 (zamba2's shared block, MHA), hd 64 with G = 4, and a
    # second 128-key tile holding one key under a window shorter than a tile
    def flash_bwd_make(Bq, S, T, H, K, hd, window, causal):
        def make(dtype):
            g = torch.Generator(device=dev).manual_seed(4)
            a = {"q": randn(g, (Bq, S, H, hd), dtype), "k": randn(g, (Bq, T, K, hd), dtype),
                 "v": randn(g, (Bq, T, K, hd), dtype), "do": randn(g, (Bq, S, H, hd), dtype),
                 "window": window, "causal": causal}
            # o and lse from the forward kernel (uncounted), its lse checked
            a["o"], a["lse"] = flash_attention_cuda(a["q"], a["k"], a["v"], causal=causal,
                                                    window=window, return_lse=True)
            want = flash_attention_lse_plain(a["q"], a["k"], causal=causal, window=window)
            a["lse_err"] = float((a["lse"] - want).abs().max() / want.abs().max())
            # library yardstick: autograd through SDPA (GQA), its forward done here
            a["lq"], a["lk"], a["lv"] = (t.transpose(1, 2).detach().requires_grad_()
                                         for t in (a["q"], a["k"], a["v"]))
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(T, device=dev)[None, :]
            mask = None if window is None else (cols <= rows) & (cols > rows - window)
            a["lout"] = F.scaled_dot_product_attention(
                a["lq"], a["lk"], a["lv"], attn_mask=mask, is_causal=mask is None and causal,
                enable_gqa=True)
            a["ldo"] = a["do"].transpose(1, 2)
            return a
        return make

    # (B, S, T, H, K, hd, window, causal, main): S = T and causal unless listed
    flash_bwd_cases = [(Bq, S, S, H, K, hd, window, True, main)
                       for Bq, S, H, K, hd, window, main in [
            (TRAIN_B, TRAIN_S, 24, 8, 128, None, PHI), (2, 1024, 24, 8, 128, 256, None),
            (2, 1000, 24, 8, 128, None, None), (2, 512, 32, 32, 112, None, None),
            (2, 300, 16, 4, 64, None, None), (2, 65, 24, 8, 128, 64, None),
            (2, 129, 24, 8, 128, 64, None), (TRAIN_B, TRAIN_S, 16, 8, 64, None, GRAN),
            # gemma3 training, hd 256 (G 2): global and local (window 1024)
            # layers; ragged S under a short window, one q tile, and a kv tile
            # of one key
            (TRAIN_B, TRAIN_S, 16, 8, 256, None, GEM),
            (TRAIN_B, TRAIN_S, 16, 8, 256, 1024, GEM_TRAIN_LOCAL),
            (2, 1000, 16, 8, 256, 100, None), (2, 17, 4, 2, 256, None, None),
            (2, 65, 4, 2, 256, 64, None),
            # zamba2's shared block in training (hd 112, MHA)
            (TRAIN_B, TRAIN_S, 32, 32, 112, None, ZAMBA)]]
    # whisper-tiny training (6 heads of 64): the encoder (non-causal, 1500),
    # the cross-attention (non-causal, 448 queries against 1500 keys), the
    # decoder's self-attention (causal); ragged S and T, GQA
    flash_bwd_cases += [
        (TRAIN_B, WH_FRAMES, WH_FRAMES, 6, 6, 64, None, False, WH_TRAIN_ENC),
        (TRAIN_B, 448, WH_FRAMES, 6, 6, 64, None, False, WH_TRAIN_CROSS),
        (TRAIN_B, 448, 448, 6, 6, 64, None, True, WH),
        (2, 129, 257, 6, 3, 64, None, False, None), (2, 300, 65, 4, 2, 64, None, False, None)]
    for Bq, S, T, H, K, hd, window, causal, main in flash_bwd_cases:
        pairs = sum(min(r + 1, window or r + 1) for r in range(S)) if causal else S * T
        cases.append(dict(
            kernel="flash_attention_bwd",
            desc={"B": Bq, "S": S, "T": T, "H": H, "K": K, "hd": hd, "causal": causal,
                  "window": window},
            make=flash_bwd_make(Bq, S, T, H, K, hd, window, causal), grads=True,
            run=lambda a: flash_attention_bwd_cuda(a["q"], a["k"], a["v"], a["o"], a["lse"],
                                                   a["do"], causal=a["causal"],
                                                   window=a["window"]),
            plain=lambda a: flash_attention_bwd_plain(a["q"], a["k"], a["v"], a["o"], a["lse"],
                                                      a["do"], causal=a["causal"],
                                                      window=a["window"]),
            library=lambda a: torch.autograd.grad(a["lout"], (a["lq"], a["lk"], a["lv"]),
                                                  a["ldo"], retain_graph=True),
            # q, o, dO and dq (H heads), k, v, dk and dv (K heads); lse
            nbytes=lambda isz, Bq=Bq, S=S, T=T, H=H, K=K, hd=hd: (4 * Bq * S * H * hd
                                                                  + 4 * Bq * T * K * hd) * isz
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
                        ((B * PROMPT, 5120), None), ((2, 33, 3072), None),
                        ((TRAIN_B * TRAIN_S, 1024), GRAN),
                        # gemma3's layer norms, q-norm (16 heads) and k-norm (8);
                        # zamba2's
                        ((TRAIN_B * TRAIN_S, 3840), GEM), ((TRAIN_B * TRAIN_S * 16, 256), None),
                        ((TRAIN_B * TRAIN_S * 8, 256), None),
                        ((TRAIN_B * TRAIN_S, 3584), ZAMBA),
                        # xlstm's residual and d_inner norms; whisper's encoder
                        ((TRAIN_B * TRAIN_S, 2048), XL), ((TRAIN_B * TRAIN_S, 4096), XL_INNER),
                        ((TRAIN_B * WH_FRAMES, 384), WH)]:
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

    T, mid = PROMPT + GEN, PROMPT + GEN // 2      # mid: the main path's middle decode step
    decode_shapes = [(40, 8, 128, T, kv_len, window, None)
                     for kv_len in (1, 37, 300, T) for window in (None, 64)]
    decode_shapes += [(40, 8, 128, T, mid, None, QWEN), (32, 32, 112, T, 1, None, None),
                      (32, 32, 112, T, 300, None, None), (32, 32, 112, T, mid, None, ZAMBA),
                      (32, 32, 112, T, 17, None, None), (32, 32, 112, T, T, None, None),
                      (32, 32, 112, T, 17, 64, None), (32, 4, 128, T, mid, None, QMOE),
                      # gemma3, hd 256: the local layers' 1024-slot ring, full
                      # (as on the main path) and partly filled; a global
                      # layer's cache at the first decode step; internvl2's
                      (16, 8, 256, 1024, 1024, None, GEM_LOCAL),
                      (16, 8, 256, 1024, 300, None, None),
                      (16, 8, 256, 1536 + GEN, 1537, None, GEM),
                      (16, 8, 128, 256 + T, 256 + mid, None, INTERN),
                      # whisper-tiny: the cross-attention over all 1500
                      # encoder keys; the self-attention's cache mid-way
                      (6, 6, 64, WH_FRAMES, WH_FRAMES, None, WH_CROSS),
                      (6, 6, 64, 416 + GEN, 416 + GEN // 2, None, WH)]
    # the per-row lse the sequence-sharded decode merges by: qwen3-14b's and
    # gemma3's global layers' shapes
    decode_shapes += [(40, 8, 128, T, mid, None, QWEN_LSE, True),
                      (16, 8, 256, 1536 + GEN, 1537, None, None, True)]
    for H, K, hd, T, kv_len, window, main, *lse in decode_shapes:
        lse = bool(lse)
        def make(dtype, H=H, K=K, hd=hd, T=T, kv_len=kv_len, window=window):
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
        cases.append(dict(
            kernel="decode_attention",
            desc={"B": B, "T": T, "H": H, "K": K, "hd": hd, "kv_len": kv_len,
                  "window": window, **({"lse": True} if lse else {})},
            make=make, n_out=2 if lse else 1,
            run=lambda a, lse=lse: decode_attention_cuda(
                a["q"], a["k"], a["v"], kv_len=a["kv_len"], window=a["window"], return_lse=lse),
            plain=lambda a, lse=lse: decode_attention_plain(
                a["q"], a["k"], a["v"], kv_len=a["kv_len"], window=a["window"], return_lse=lse),
            library=lambda a: F.scaled_dot_product_attention(a["lq"], a["lk"], a["lv"]),
            nbytes=lambda isz, v=valid, H=H, K=K, hd=hd, lse=lse: (
                (2 * B * H * hd + 2 * B * v * K * hd) * isz + 4 * B * H * lse),
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

    # ssd_intra_chunk_bwd: the forward's shapes (P 128 takes two passes of
    # 64 columns) and zamba2-7b's training shape (B 4, S 2048: 16 chunks),
    # held to the plain version in float64 (dla is a reverse cumsum of
    # differences, where float32 loses digits of its own)
    for (Bs, nc, Q, H, N, P), la_kind, main in [
            ((2, 4, 32, 8, 16, 16), "small", None), ((1, 2, 64, 4, 64, 64), "small", None),
            ((1, 1, 16, 1, 8, 8), "small", None), ((1, 2, 40, 3, 4, 12), "mixed", None),
            ((1, 1, 128, 2, 64, 128), "small", None),
            ((B, PROMPT // 128, 128, 112, 64, 64), "model", None),
            ((TRAIN_B, TRAIN_S // 128, 128, 112, 64, 64), "small", ZAMBA),
            ((TRAIN_B, TRAIN_S // 128, 128, 112, 64, 64), "model", None)]:
        def make(dtype, shape=(Bs, nc, Q, H, N, P), la_kind=la_kind):
            Bs, nc, Q, H, N, P = shape
            g = torch.Generator(device=dev).manual_seed(6)
            z = torch.randn((Bs, nc, Q, H), generator=g, device=dev)
            la = {"small": -z.abs() * 0.1, "model": -F.softplus(z), "mixed": z * 0.05}[la_kind]
            a = {"la": la}
            for k, shp in (("C", (Bs, nc, Q, N)), ("B", (Bs, nc, Q, N)), ("x", (Bs, nc, Q, H, P)),
                           ("dy", (Bs, nc, Q, H, P)), ("dst", (Bs, nc, H, P, N)),
                           ("dtot", (Bs, nc, H))):
                a[k] = randn(g, shp, dtype)
            return a
        BC, tri = Bs * nc, Q * (Q + 1) // 2
        names = "la C B x dy dst dtot".split()
        cases.append(dict(
            kernel="ssd_intra_chunk_bwd",
            desc={"B": Bs, "nc": nc, "Q": Q, "H": H, "N": N, "P": P, "la": la_kind},
            make=make, dtypes=("float32",), grads=True,
            run=lambda a: ssd_intra_chunk_bwd_cuda(*(a[k] for k in names)),
            plain=lambda a: ssd_intra_chunk_bwd_plain(*(a[k] for k in names)),
            oracle=lambda a: ssd_intra_chunk_bwd_plain(*(a[k].double() for k in names)),
            library=None,
            # la, C, B, x, dy, dstate, dtot read once; dla, dC, dB, dx written
            nbytes=lambda isz, BC=BC, Q=Q, H=H, N=N, P=P: isz * (
                2 * BC * Q * H + 4 * BC * Q * N + 3 * BC * Q * H * P + BC * H * P * N + BC * H),
            # products in 3xTF32 as the forward's: C.B^T on s <= t, dC and dB
            # from dCB, per head dM = dy x^T and M^T dy on s <= t, B dstate^T
            # and x dstate; outside them per head M, dCB, G on s <= t
            flops={"tf32": 3 * (6 * BC * N * tri + BC * H * (4 * P * tri + 4 * Q * P * N)),
                   "float32": BC * H * (6 * tri + 4 * Q * N)},
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
                tols = case.get("tols", (TOL[dtype_name],) * case.get("n_out", 1))
                err, ok = compare(torch, out, want, tols)
            extra = {"lse_rel_err": a["lse_err"]} if "lse_err" in a else {}
            if "lse_err" in a and not a["lse_err"] < 1e-5:
                ok = False
            if case.get("oracle"):
                extra["plain_err_vs_float64"] = compare(torch, case["plain"](a), want, tols)[0]
            isz = 2 if dtype_name == "bfloat16" else 4
            nbytes = case["nbytes"](isz)
            rot = rotating([a] + [case["make"](dtypes[dtype_name])
                                  for _ in range(copies_for(nbytes) - 1)])
            ms = time_ms(torch, lambda: rot(case["run"]))
            dev_ms = device_ms(torch, lambda: rot(case["run"]))
            plain_ms = time_ms(torch, lambda: rot(case["plain"]))
            lib_ms = lib_dev_ms = None
            if case["library"]:
                lib_ms = time_ms(torch, lambda: rot(case["library"]))
                lib_dev_ms = device_ms(torch, lambda: rot(case["library"]))
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
            del rot, a, out, want
    if failures:
        raise AssertionError(f"{len(failures)} kernel case(s) disagree with the plain version")
    return main_rows


# -- model phases ----------------------------------------------------------------
def _xlstm_norms(cfg) -> int:
    """An xLSTM forward's norms: 3 a sLSTM block (in, gated, FFN), 2 an
    mLSTM layer (its own and the mixer's gated one), the final norm."""
    nb = cfg.n_layers // cfg.slstm_period
    return 3 * nb + 2 * nb * (cfg.slstm_period - 1) + 1


def expected_launches(cfg, gen: int) -> dict:
    """One prefill and gen - 1 decode steps. Dense and MoE: flash L per prefill,
    decode L per step, rmsnorm 2L + 1 layer norms (and 2L qk-norms) per
    forward. Hybrid (ng shared-block sites): flash ng per prefill, decode ng
    per step, rmsnorm 2L + 2ng + 1 per forward, ssd L per prefill. xLSTM:
    rmsnorm only (``_xlstm_norms`` a forward). Whisper (E encoder layers, L
    decoder layers): the encoder once, its 2E norms and enc_norm, flash E;
    each decoder forward 3L + 1 norms; flash 2L at the prefill (self and
    cross), decode 2L a step."""
    L = cfg.n_layers
    bwd = {"rmsnorm_bwd": 0, "flash_attention_bwd": 0, "ssd_intra_chunk_bwd": 0}
    none = {"flash_attention": 0, "decode_attention": 0, "ssd_intra_chunk": 0}
    if cfg.family == "ssm":
        return {**none, "rmsnorm": _xlstm_norms(cfg) * gen, **bwd}
    if cfg.family == "audio":
        E = cfg.encoder_layers
        return {**none, "rmsnorm": 2 * E + 1 + (3 * L + 1) * gen, "flash_attention": E + 2 * L,
                "decode_attention": 2 * L * (gen - 1), **bwd}
    if cfg.family == "hybrid":
        ng = L // cfg.shared_attn_every
        return {"rmsnorm": (2 * L + 2 * ng + 1) * gen, "flash_attention": ng,
                "decode_attention": ng * (gen - 1), "ssd_intra_chunk": L, **bwd}
    return {"rmsnorm": ((2 + 2 * cfg.qk_norm) * L + 1) * gen, "flash_attention": L,
            "decode_attention": L * (gen - 1), "ssd_intra_chunk": 0, **bwd}


def expected_train_launches(cfg, steps: int, evals: int, remat: bool) -> dict:
    """``steps`` train steps and ``evals`` no-grad loss evaluations: a step
    runs each remat-wrapped layer's forward once, and once more in the
    backward under remat "full", then the backward. Dense and MoE (every
    layer wrapped): norms per layer 2 (and 2 qk-norms), plus the final norm
    outside the remat. Hybrid (ng shared-block sites, the shared block not
    wrapped, as ``repro``'s): per mamba layer 2 norms (its own and the
    mixer's gated one) and one SSD intra-chunk block; per site 2 norms (and
    2 qk-norms) and one attention; plus the final norm. xLSTM (the mLSTM
    layers wrapped, the sLSTM blocks not, as ``repro``'s): 2 norms an mLSTM
    layer, 3 a sLSTM block, the final norm. Whisper (every encoder and
    decoder layer wrapped): 2 norms and one attention an encoder layer, 3
    norms and two attentions a decoder layer, enc_norm and the final norm
    outside."""
    fwd = 2 if remat else 1
    if cfg.family == "ssm":
        nb = cfg.n_layers // cfg.slstm_period
        m_norms = 2 * nb * (cfg.slstm_period - 1)
        once = _xlstm_norms(cfg) - m_norms
        return {"rmsnorm": steps * (once + m_norms * fwd) + evals * (once + m_norms),
                "flash_attention": 0, "decode_attention": 0, "ssd_intra_chunk": 0,
                "rmsnorm_bwd": steps * (once + m_norms), "flash_attention_bwd": 0,
                "ssd_intra_chunk_bwd": 0}
    if cfg.family == "audio":
        E, L = cfg.encoder_layers, cfg.n_layers
        norms, attn = 2 * E + 3 * L, E + 2 * L
        return {"rmsnorm": steps * (norms * fwd + 2) + evals * (norms + 2),
                "flash_attention": (steps * fwd + evals) * attn, "decode_attention": 0,
                "ssd_intra_chunk": 0, "rmsnorm_bwd": steps * (norms + 2),
                "flash_attention_bwd": steps * attn, "ssd_intra_chunk_bwd": 0}
    if cfg.family == "hybrid":
        L = cfg.n_layers
        ng = L // cfg.shared_attn_every
        site = (2 + 2 * cfg.qk_norm) * ng + 1
        return {"rmsnorm": steps * (2 * L * fwd + site) + evals * (2 * L + site),
                "flash_attention": (steps + evals) * ng, "decode_attention": 0,
                "ssd_intra_chunk": steps * L * fwd + evals * L,
                "rmsnorm_bwd": steps * (2 * L + site), "flash_attention_bwd": steps * ng,
                "ssd_intra_chunk_bwd": steps * L}
    L, n = cfg.n_layers, 2 + 2 * cfg.qk_norm
    return {"rmsnorm": steps * (n * L * fwd + 1) + evals * (n * L + 1),
            "flash_attention": steps * L * fwd + evals * L, "decode_attention": 0,
            "ssd_intra_chunk": 0, "rmsnorm_bwd": steps * (n * L + 1),
            "flash_attention_bwd": steps * L, "ssd_intra_chunk_bwd": 0}


def model_inputs(torch, cfg, B: int, dev, seeded: bool = False) -> dict:
    """What ``cfg``'s family takes beside the prompts, on ``dev``, as the
    serve driver makes it (internvl2's seeded patch embeddings, whisper's
    zero frames); with ``seeded`` whisper's frames 0.1 N(0, 1) from a seed
    instead, so that a reference's encoder sees varied input."""
    from repro_torch.launch.serve import model_inputs as driver_inputs
    if seeded and cfg.family == "audio":
        g = torch.Generator(device=dev).manual_seed(3)
        return {"frames": 0.1 * torch.randn((B, cfg.encoder_seq, cfg.d_model), device=dev,
                                            generator=g).to(getattr(torch, cfg.dtype))}
    return driver_inputs(cfg, B, dev, 2)


def run_reference_phase(torch, arch: str, n_layers: int, prompt: int) -> None:
    """``arch``'s widths, ``n_layers`` layers, float32, B 2, gen 4: kernels on
    the card against the plain path on the CPU, same weights, prompts and
    (internvl2) patch embeddings or (whisper, all its encoder layers) seeded
    frames."""
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
    extra = model_inputs(torch, cfg, 2, dev, seeded=True)
    t0 = time.perf_counter()
    card = generate(model, params, prompts, 4, **extra)
    card_s = time.perf_counter() - t0
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = generate(model, cpu_params, prompts.cpu(), 4, **{k: v.cpu() for k, v in extra.items()})
    cpu_s = time.perf_counter() - t0
    a, b = card["last_logits"].float().cpu(), host["last_logits"].float()
    rel = float((a - b).abs().max() / b.abs().max())
    same = bool(torch.equal(card["tokens"].cpu(), host["tokens"]))
    emit({"phase": "reference", "cfg": f"{arch} n_layers={n_layers} float32", "B": 2,
          "prompt": prompt, **_prefix_desc(extra), "gen": 4,
          "logits_rel_err": rel, "tol": 1e-4, "tokens_equal": same, "card_s": card_s,
          "cpu_s": cpu_s})
    if not (rel < 1e-4 and same):
        raise AssertionError(f"{arch}: card kernel path disagrees with the CPU plain path")


@contextlib.contextmanager
def route_tape(torch, record=None, replay=None):
    """Watch ``repro_torch.models.moe.route`` through ``moe.observe`` for a
    comparison run. ``record`` (a list) gets each call's layer params,
    input, logits, w and idx. ``replay`` (another run's record) makes the
    k-th call take the k-th recorded expert ids, with w the renormalised
    probabilities at them (what the routing gives for those ids), and holds
    this side's router on the recorded call's input: the yielded dict gets
    the worst router-logit error as a share of max|logit| (``logit_err``)
    and the count of tokens whose own top-k set differs (``flips``)."""
    from repro_torch.models import moe
    calls, seen = [0], {"flips": 0, "logit_err": 0.0}

    def hook(p, x, logits, probs, w, idx):
        if replay is not None:
            rec = replay[calls[0]]
            calls[0] += 1
            want = rec["idx"].to(idx.device)
            seen["flips"] += int((idx.sort(-1).values != want.sort(-1).values).any(-1).sum())
            mine = rec["x"].to(x.device).float() @ p["router"]["w"].float()
            seen["logit_err"] = max(seen["logit_err"],
                                    _rel_to_max(torch, mine.cpu(), rec["logits"].cpu()))
            w = torch.gather(probs, -1, want)
            w, idx = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype), want
        if record is not None:
            record.append({"p": p, "x": x.detach(), "logits": logits.detach(),
                           "w": w.detach(), "idx": idx})
        return w, idx

    with moe.observe(route_hook=hook):
        yield seen


def run_moe_reference_phase(torch, arch: str, n_layers: int, prompt: int) -> None:
    """``arch``'s widths, ``n_layers`` layers, float32, B 2, gen 4: the card's
    kernel path against the CPU plain path, same weights and prompts, each
    side's routing recorded. Two correct implementations pick different
    experts where the k-th and (k+1)-th probabilities are within rounding of
    each other, so the whole model is not held across such a flip. Held
    instead, for every routing call (layer, prefill or decode step), on the
    card's own input to it: the router logits within 1e-5 of max|logit|,
    and the dispatch/experts/combine half fed the same (w, idx) on both
    sides within 1e-4 of max|y|. Then the (call, token) routes that differ
    between the two runs are counted, and the rows whose routes all agree
    are held as the dense reference is: logits within 1e-4 of max|logit|,
    equal greedy tokens (at least one row must agree)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    card_calls, cpu_calls = [], []
    with route_tape(torch, record=card_calls):
        card = generate(model, params, prompts, 4)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with route_tape(torch, record=cpu_calls):
        host = generate(model, cpu_params, prompts.cpu(), 4)
    logit_err = ffn_err = 0.0
    row_ok = torch.ones(2, dtype=torch.bool)
    differing = 0
    for c, h in zip(card_calls, cpu_calls, strict=True):
        x = c["x"].cpu()
        want = c["logits"].cpu()
        logit_err = max(logit_err, _rel_to_max(torch, moe.route(h["p"], x, cfg)[0], want))
        y_card = moe.experts(c["p"], c["x"], c["w"], c["idx"], cfg).cpu()
        y_cpu = moe.experts(h["p"], x, c["w"].cpu(), c["idx"].cpu(), cfg)
        ffn_err = max(ffn_err, _rel_to_max(torch, y_card, y_cpu))
        same = (c["idx"].cpu().sort(-1).values == h["idx"].sort(-1).values).all(-1)  # (B, S)
        differing += int((~same).sum())
        row_ok &= same.all(-1)
    rows = row_ok.nonzero().flatten().tolist()
    a, b = card["last_logits"].float().cpu()[rows], host["last_logits"].float()[rows]
    rel = float((a - b).abs().max() / b.abs().max()) if rows else float("nan")
    same_tokens = bool(torch.equal(card["tokens"].cpu()[rows], host["tokens"][rows]))
    emit({"phase": "reference", "cfg": f"{arch} n_layers={n_layers} float32", "B": 2,
          "prompt": prompt, "gen": 4, "routing_calls": len(card_calls),
          "router_logits_rel_err": logit_err, "router_tol": 1e-5,
          "shared_routing_ffn_rel_err": ffn_err, "ffn_tol": 1e-4,
          "routes_differing": differing, "rows_compared": rows,
          "logits_rel_err": rel, "tol": 1e-4, "tokens_equal": same_tokens})
    if not (logit_err < 1e-5 and ffn_err < 1e-4 and rows and rel < 1e-4 and same_tokens):
        raise AssertionError(f"{arch}: card kernel path disagrees with the CPU plain path")


def _prefix_desc(extra: dict) -> dict:
    """The rows a run's extra inputs put before or beside the prompt."""
    return {"patches": extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0,
            **({"frames": extra["frames"].shape[1]} if "frames" in extra else {})}


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
    prompt = SERVE_PROMPT.get(arch, PROMPT)
    t0 = time.perf_counter()
    ops.reset_launches()
    res = serve(cfg, requests=B, prompt_len=prompt, gen=GEN, seed=0, device="cuda", log=log)
    got = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not (res["stage_bytes"] == res["published_bytes"]
            and 0 < res["published_bytes"] - res["manifest_bytes"] < 1 << 20):
        raise AssertionError("staged bytes differ from what was published")
    emit({"phase": "staged", "cfg": f"{arch} n_layers={n_layers} bf16", "B": B,
          "prompt": prompt, "patches": cfg.n_patches if cfg.family == "vlm" else 0,
          **({"frames": cfg.encoder_seq} if cfg.family == "audio" else {}),
          "gen": GEN, "stage_bytes": res["stage_bytes"],
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
    prompt = SERVE_PROMPT.get(arch, PROMPT)
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    extra = model_inputs(torch, cfg, B, dev)
    generate(model, params, prompts, 2, **extra)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = generate(model, params, prompts, GEN, **extra)
    got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not torch.isfinite(res["last_logits"].float()).all():
        raise AssertionError("non-finite logits")
    steps = GEN - 1
    emit({"phase": "full", "cfg": f"{arch} {cfg.n_layers} layers bf16", "params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s, "B": B, "prompt": prompt,
          **_prefix_desc(extra), "gen": GEN,
          "prefill_ms": res["prefill_s"] * 1e3,
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


def run_train_reference_phase(torch, arch: str, n_layers: int = 2, n_batch: int = 2,
                              seq: int = 200, window=None, optimizer: bool = True,
                              oracle64: bool = False) -> dict:
    """``arch``'s widths, ``n_layers`` layers, float32, ``n_batch`` x ``seq``
    (200: ragged tiles), gemma3's window cut to ``window`` where given: the
    card's kernel path (remat "full") against the CPU plain path, same
    weights and batch: the loss within 1e-4 and every grad leaf within 1e-4
    of its max|g|. With ``optimizer``, AdamW applied to the same grads (the
    card's) on each side, the updated params within 1e-5 of their max; then
    one train step on each side, its loss equal to the first.

    With ``oracle64`` the card is held to the CPU plain path run in float64
    (the same weights widened), and the float32 CPU run is reported beside
    it: at zamba2's widths with 7 layers each float32 run is 4e-5 to 7e-5 of
    max|g| off the float64 one in some leaf, spread over the network (no one
    op; measured on an H100), so two float32 runs differ by up to their sum.

    Each side's own train step is not held to 1e-5: AdamW's first update is
    lr * g / (|g| + eps), lr * sign(g) wherever |g| >> eps, so a grad entry
    within float32 rounding of zero takes opposite signs on the two sides
    and moves by 2 lr. That gap is reported, not checked.

    MoE: the card's routing is recorded and the CPU side takes the same
    expert ids call for call (``route_tape``), so that both compute one
    function. The CPU's router is held on the card's input to each call,
    its logits within 1e-5 of max|logit|, so a fault in the card's routing
    is not replayed unseen; the tokens whose own CPU top-k differed are
    reported."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import (RuntimeConfig, TrainState, loss_and_grads,
                                     make_train_step)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", schedule="constant", opt=optim.AdamWConfig(lr=1e-3))
    step = make_train_step(model, rt)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = tree_map(lambda t: t.to("cpu", copy=True), params)   # stepped in place
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (n_batch, seq + 1), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **model_inputs(torch, cfg, n_batch, dev, seeded=True)}
    sides, tape = {}, []
    ops.reset_launches()
    for side in ("card", "cpu") + (("cpu64",) if oracle64 else ()):
        if side == "cpu":
            launches = dict(ops.LAUNCHES)
            params = cpu_params
            batch = {k: v.cpu() for k, v in batch.items()}
            torch.cuda.empty_cache()
        if side == "cpu64":
            params = tree_map(lambda t: t.detach().double(), cpu_params)
            batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        if cfg.family != "moe":
            routing = contextlib.nullcontext({"flips": 0, "logit_err": 0.0})
        elif side == "card":
            routing = route_tape(torch, record=tape)
        else:
            routing = route_tape(torch, replay=tape)
        t0 = time.perf_counter()
        with routing as seen:
            loss, _, grads = loss_and_grads(model, params, batch, remat=rt.remat)
            grads = tree_map(lambda t: t.cpu(), grads)
            if side == "card":
                card_grads = grads
            else:
                sides[side + " grad_err"] = max(_rel_to_max(torch, a, b)
                                               for a, b in zip(leaves(card_grads), leaves(grads)))
            del grads
            sides[side] = {"loss": float(loss), **seen}
            if optimizer:
                same = tree_map(lambda t: t.to(params["embed"]["w"].device), card_grads)
                upd = tree_map(lambda t: t.detach().clone(), params)
                upd, _, _ = optim.update(same, optim.init(upd), upd, rt.opt)
                sides[side]["updated"] = [t.cpu() for t in leaves(upd)]
                del upd, same
                state, metrics = step(TrainState(params, optim.init(params), ()), batch)
                sides[side]["step_loss"] = float(metrics["loss"])
                sides[side]["stepped"] = [t.detach().cpu() for t in leaves(state.params)]
                del state
        if side == "card":
            torch.cuda.synchronize()
        sides[side]["s"] = time.perf_counter() - t0
    del tape
    card, cpu = sides["card"], sides["cpu"]
    oracle = "cpu64" if oracle64 else "cpu"
    loss_err = abs(card["loss"] - sides[oracle]["loss"])
    grad_err = sides[oracle + " grad_err"]
    row = {"phase": "train reference", "cfg": f"{arch} n_layers={n_layers} float32"
           + (f" window={window}" if window is not None else ""),
           "B": n_batch, "S": seq, "oracle": "CPU float64" if oracle64 else "CPU float32",
           "loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss_abs_err": loss_err, "loss_tol": 1e-4, "grad_err_of_max": grad_err,
           "grad_tol": 1e-4,
           **({"loss_cpu64": sides["cpu64"]["loss"],
               "grad_err_of_max_vs_cpu_float32": sides["cpu grad_err"],
               "cpu64_s": sides["cpu64"]["s"]} if oracle64 else {}),
           **({"router_logits_rel_err": cpu["logit_err"], "router_tol": 1e-5,
               "cpu_route_flips": cpu["flips"]} if cfg.family == "moe" else {}),
           "card_s": card["s"], "cpu_s": cpu["s"], "launches": launches}
    ok = loss_err < 1e-4 and grad_err < 1e-4 and cpu["logit_err"] < 1e-5
    if optimizer:
        param_err = max(_rel_to_max(torch, a, b)
                        for a, b in zip(card["updated"], cpu["updated"]))
        own_err = max(_rel_to_max(torch, a, b)
                      for a, b in zip(card["stepped"], cpu["stepped"]))
        row.update({"param_err_of_max_same_grads": param_err, "param_tol": 1e-5,
                    "param_err_of_max_own_steps": own_err, "lr": rt.opt.lr})
        ok = (ok and param_err < 1e-5 and card["step_loss"] == card["loss"]
              and cpu["step_loss"] == cpu["loss"])
    emit(row)
    if not ok:
        raise AssertionError(f"train reference {arch}: the card's kernel path disagrees "
                             "with the CPU plain path")
    check_launches(launches, {k: (2 if optimizer else 1) * v for k, v in
                              expected_train_launches(cfg, 1, 0, True).items()},
                   f"train reference {arch}")
    return launches


def run_train_staged_phase(torch, arch: str) -> dict:
    """``launch.train.train`` end to end on the card on the smoke ``arch``
    with head dim 64 (the kernels' smallest): corpus staged, 6 steps,
    checkpoints at 3 and 6 saved to the burst tier and drained, the held
    batch improved."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64)
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
        raise AssertionError(f"train staged {arch}: no improvement or no committed, "
                             "drained step")
    check_launches(got, expected_train_launches(cfg, steps, 2, True), f"train staged {arch}")
    return got


def run_train_full_phase(torch, arch: str, stats: dict | None = None) -> dict:
    """``arch`` at full width, ``TRAIN_LAYERS[arch]`` layers, bf16 params,
    fp32 AdamW state, B 4, S 2048, remat "full": one warm-up step, then
    TRAIN_STEPS timed steps on Loader batches. ``stats[arch]``, where given,
    takes the mean step ms and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data import DatasetSpec, Loader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import RuntimeConfig, make_train_state, make_train_step
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS[arch])
    seq = TRAIN_SEQ.get(arch, TRAIN_S)
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", opt=AdamWConfig(lr=1e-4), schedule="constant")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), rt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    loader = Loader(DatasetSpec(seed=7, vocab=cfg.vocab_size, n_tokens=1 << 24),
                    batch=TRAIN_B, seq=seq)
    step = make_train_step(model, rt)
    state, _ = step(state, to_device(loader.batch_at(0), cfg, dev))     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for i in range(1, TRAIN_STEPS + 1):
        batch = to_device(loader.batch_at(i), cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"loss": float(m["loss"]), "ce": float(m["ce"]), "aux": float(m["aux"]),
                      "grad_norm": float(m["grad_norm"]),
                      "step_ms": dt * 1e3, "tokens_per_s": TRAIN_B * seq / dt,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    got = dict(ops.LAUNCHES)
    mean_ms = sum(x["step_ms"] for x in steps) / len(steps)
    peak = max(x["peak_memory_bytes"] for x in steps)
    if stats is not None:
        stats[arch] = {"mean_step_ms": mean_ms, "peak_memory_bytes": peak}
    emit({"phase": "train full",
          "cfg": f"{arch} {cfg.n_layers} of {full.n_layers} layers bf16, fp32 AdamW",
          "params": n_params, "init_s": init_s, "B": TRAIN_B, "S": seq,
          **({"frames": cfg.encoder_seq} if cfg.family == "audio" else {}),
          "remat": rt.remat, "steps": steps, "mean_step_ms": mean_ms,
          "mean_tokens_per_s": TRAIN_B * seq / mean_ms * 1e3,
          "peak_memory_bytes": peak, "launches": got})
    if not all(math.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in steps):
        raise AssertionError(f"train full {arch}: a non-finite loss or a zero grad norm")
    check_launches(got, expected_train_launches(cfg, TRAIN_STEPS, 0, True),
                   f"train full {arch}")
    del state
    return got


# -- the mesh phase ------------------------------------------------------------
MESH_TRAIN_STEPS = 3
MESH_SERVE_KERNELS = ("decode_attention", "flash_attention", "rmsnorm")
MESH_TRAIN_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def run_mesh_phase(torch) -> dict:
    """The mesh steps (``runtime.parallel.shard_*``) in this process
    on an NCCL world of 1, mesh (data 1, model 1): params, caches, batches
    and optimizer state are DTensors, the kernels run on local shards. Each
    run is held to the same run through the one-device steps: qwen3-14b
    at all 40 layers served (tokens and kernel launches equal), phi4-mini-3.8b
    (8 of 32 layers) trained 3 steps with ZeRO-1 (losses within 1e-3, the
    forward and backward kernels' launches equal). The times are printed
    beside the one-device ones: DTensor's cost on the host."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh(1, 1, "cuda")
        got = {"mesh serve " + QWEN: _mesh_serve(torch, mesh)}
        torch.cuda.empty_cache()
        got["mesh train " + PHI] = _mesh_train(torch, mesh)
    finally:
        dist.destroy_process_group()
    return got


def _mesh_serve(torch, mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.runtime import RuntimeConfig, distribute_tree, shard_decode_step, \
        shard_prefill
    cfg = get_config(QWEN)
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    generate(model, params, prompts, 2)                     # warm-up
    ops.reset_launches()
    ref = generate(model, params, prompts, GEN)
    ref_launches = dict(ops.LAUNCHES)

    S_max, rt = PROMPT + GEN, RuntimeConfig()
    batch = {"tokens": prompts}
    cache_like = model.init_cache(B, S_max, "meta")
    prefill, p_sh, _, c_sh = shard_prefill(model, mesh, rt, S_max, params, batch, cache_like)
    decode, _, _, _ = shard_decode_step(model, mesh, rt, params, cache_like,
                                        {"token": prompts[:, 0]})
    dparams = distribute_tree(mesh, params, p_sh)

    def sharded_generate(gen: int) -> dict:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(dparams, batch)
        tok = _full(logits).argmax(-1)
        out = [tok]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = decode(dparams, cache, {"token": tok})
            tok = _full(logits).argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        return {"tokens": torch.stack(out, dim=1), "prefill_s": t1 - t0,
                "decode_s": time.perf_counter() - t1,
                "cache": [repr(p) for p in cache["k"].placements]}

    sharded_generate(2)                                     # warm-up
    ops.reset_launches()
    res = sharded_generate(GEN)
    got = dict(ops.LAUNCHES)
    same = bool(torch.equal(res["tokens"], ref["tokens"]))
    steps = GEN - 1
    emit({"phase": "mesh", "run": "serve", "cfg": f"{QWEN} {cfg.n_layers} layers bf16",
          "mesh": {"data": 1, "model": 1}, "backend": "nccl", "B": B, "prompt": PROMPT,
          "gen": GEN, "tokens_equal": same, "cache_placements": res["cache"],
          "prefill_ms": res["prefill_s"] * 1e3, "prefill_ms_unsharded": ref["prefill_s"] * 1e3,
          "decode_ms_per_step": res["decode_s"] / steps * 1e3,
          "decode_ms_per_step_unsharded": ref["decode_s"] / steps * 1e3,
          "launches": got, "launches_unsharded": ref_launches})
    check_output(res["tokens"], cfg.padded_vocab, (B, GEN))
    if not same:
        raise AssertionError("mesh serve: the sharded tokens differ from the one-device run's")
    for name in MESH_SERVE_KERNELS:
        if got[name] != ref_launches[name] or not got[name]:
            raise AssertionError(f"mesh serve: {name} launched {got[name]} times, "
                                 f"{ref_launches[name]} on one device")
    check_launches(got, expected_launches(cfg, GEN), f"mesh serve {QWEN}")
    del params, dparams
    return got


def _mesh_train(torch, mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import DatasetSpec, Loader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import RuntimeConfig, distribute_tree, make_train_state, \
        make_train_step, shard_train_step
    full = get_config(PHI)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS[PHI])
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", zero1=True, opt=AdamWConfig(lr=1e-4), schedule="constant")
    dev = torch.device("cuda")
    loader = Loader(DatasetSpec(seed=7, vocab=cfg.vocab_size, n_tokens=1 << 24),
                    batch=TRAIN_B, seq=TRAIN_S)
    batches = [to_device(loader.batch_at(i), cfg, dev) for i in range(MESH_TRAIN_STEPS)]

    def run(step, state) -> tuple[list, list, dict]:
        ops.reset_launches()
        losses, times = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(_full(m["loss"])))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times, dict(ops.LAUNCHES)

    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), rt)
    ref_losses, ref_ms, ref_launches = run(make_train_step(model, rt), state)
    del state
    torch.cuda.empty_cache()
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), rt)
    step, st_sh, _ = shard_train_step(model, mesh, rt, state, batches[0])
    state = distribute_tree(mesh, state, st_sh)
    torch.cuda.reset_peak_memory_stats()
    losses, ms, got = run(step, state)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    emit({"phase": "mesh", "run": "train",
          "cfg": f"{PHI} {cfg.n_layers} of {full.n_layers} layers bf16, fp32 AdamW, ZeRO-1",
          "mesh": {"data": 1, "model": 1}, "backend": "nccl", "B": TRAIN_B, "S": TRAIN_S,
          "remat": rt.remat, "losses": losses, "losses_unsharded": ref_losses,
          "loss_rel_err": rel, "step_ms": ms, "step_ms_unsharded": ref_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": got, "launches_unsharded": ref_launches})
    if not all(math.isfinite(x) for x in losses) or max(rel) > 1e-3:
        raise AssertionError(f"mesh train: losses {losses} against {ref_losses}")
    for name in MESH_TRAIN_KERNELS:
        if got[name] != ref_launches[name] or not got[name]:
            raise AssertionError(f"mesh train: {name} launched {got[name]} times, "
                                 f"{ref_launches[name]} on one device")
    check_launches(got, expected_train_launches(cfg, MESH_TRAIN_STEPS, 0, True),
                   f"mesh train {PHI}")
    del state
    return got


# -- the cost phase --------------------------------------------------------------
COST_ARCHS = (PHI, GEM)
COST_PEAK_TOL = 0.2


def dryrun_child(out_path: str) -> int:
    """In a process of its own (``python3 chip_smoke.py --dryrun OUT``): the
    dry-run (``launch.dryrun.run_cell``) of the train full phase's cut
    configs of ``COST_ARCHS`` at B 4, S 2048, remat "full", on a fake world
    of 1, mesh (data 1, model 1). CPU fakes only; the records go to
    ``out_path`` as one JSON list."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_fake_world, make_smoke_mesh
    init_fake_world(1)
    mesh = make_smoke_mesh(1, 1, "cpu")
    shape = ShapeSpec(f"train_{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    recs = [run_cell(dataclasses.replace(get_config(arch), n_layers=TRAIN_LAYERS[arch]), shape,
                     variant="accum=1,remat=full", mesh=mesh,
                     out_dir=os.path.join(os.path.dirname(out_path), "records"))
            for arch in COST_ARCHS]
    with open(out_path, "w") as f:
        json.dump(recs, f)
    return 0


@contextlib.contextmanager
def dryrun_child_running(out_dir: str):
    """The cost phase's dry-run, started at once so that it runs on the
    host's CPU while the card works, and stopped on the way out. Yields
    (process, path of its records, path of its log)."""
    os.makedirs(out_dir, exist_ok=True)
    out, log_path = (os.path.join(out_dir, n) for n in ("cost_records.json", "dryrun.log"))
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun", out],
                                stdout=log_f, stderr=subprocess.STDOUT)
    try:
        yield proc, out, log_path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def run_cost_phase(child, measured: dict) -> None:
    """Each dry-run record beside the train full phase's measurement of the
    same config and shape: the predicted peak (argument + temp bytes) within
    ``COST_PEAK_TOL`` of ``max_memory_allocated``, and no measured step
    faster than ``compute_s`` (all the step's flops at the bf16 peak), which
    would mean a flop count too low. The share of the bf16 peak that the
    model's flops reach in the measured step is a reading, not a gate."""
    proc, path, log_path = child
    rc = proc.wait(timeout=600)
    if rc != 0:
        with open(log_path) as f:
            raise AssertionError(f"cost: the dry-run child exited with {rc}:\n"
                                 f"{f.read()[-4000:]}")
    with open(path) as f:
        records = json.load(f)
    from repro_torch.core.perfmodel import H100
    for arch, rec in zip(COST_ARCHS, records):
        got = measured[arch]
        mem = rec["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        peak_err = abs(predicted - got["peak_memory_bytes"]) / got["peak_memory_bytes"]
        step_s = got["mean_step_ms"] / 1e3
        compute_s = rec["terms"]["compute_s"]
        emit({"phase": "cost", "cfg": f"{arch} {TRAIN_LAYERS[arch]} layers bf16, fp32 AdamW",
              "B": TRAIN_B, "S": TRAIN_S, "remat": "full", "mesh": rec["mesh"],
              "trace_s": rec["trace_s"], "alg_flops": rec["alg_flops_global"],
              "alg_dot_bytes": rec["alg_dot_bytes_global"], "alg_bytes": rec["alg_bytes_global"],
              "model_flops": rec["model_flops_global"], "terms": rec["terms"],
              "argument_bytes": mem["argument_bytes"], "temp_bytes": mem["temp_bytes"],
              "predicted_peak_bytes": predicted,
              "peak_memory_bytes": got["peak_memory_bytes"], "peak_rel_err": peak_err,
              "mean_step_ms": got["mean_step_ms"], "compute_ms": compute_s * 1e3,
              "step_over_compute": step_s / compute_s,
              "reading_model_flops_share_of_bf16_peak":
                  rec["model_flops_global"] / (step_s * H100.peak_flops_bf16)})
        if peak_err > COST_PEAK_TOL:
            raise AssertionError(f"cost {arch}: predicted peak {predicted} B is {peak_err:.1%} "
                                 f"off the measured {got['peak_memory_bytes']} B")
        if step_s < compute_s:
            raise AssertionError(f"cost {arch}: the measured step ({step_s} s) is faster than "
                                 f"its flops at the bf16 peak ({compute_s} s)")


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
    "ssd_intra_chunk_bwd": ("cuda", "src/repro_torch/csrc/ssd_intra_chunk_bwd.cu",
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
    from repro_torch.core.perfmodel import H100
    props = torch.cuda.get_device_properties(0)
    if (props.multi_processor_count, props.total_memory) != (H100.n_sms, H100.hbm_bytes):
        raise RuntimeError(f"the card ({props.name}: {props.multi_processor_count} SMs, "
                           f"{props.total_memory} B) is not the H100 profile's "
                           f"({H100.n_sms} SMs, {H100.hbm_bytes} B)")
    with dryrun_child_running(os.path.join(ROOT, "build", "dryrun")) as child:
        return run_phases(torch, build, child)


def run_phases(torch, build, child) -> int:
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
    torch.cuda.empty_cache()
    run_moe_reference_phase(torch, QMOE, 2, 32)
    torch.cuda.empty_cache()
    run_reference_phase(torch, GEM, 6, 1030)
    torch.cuda.empty_cache()
    run_reference_phase(torch, INTERN, 2, 32)
    torch.cuda.empty_cache()
    # xlstm: one block (1 sLSTM, 7 mLSTM), a prompt of two 128-token chunks,
    # the second padded; whisper: all 4 + 4 layers, 1500 seeded frames
    run_reference_phase(torch, XL, 8, 160)
    torch.cuda.empty_cache()
    run_reference_phase(torch, WH, 4, 32)
    log(f"chip_smoke: reference phases done at {time.perf_counter() - t_start:.1f} s")
    launches = {}
    for arch, staged_layers in ((QWEN, 2), (ZAMBA, 7), (QMOE, 2), (GEM, 6), (INTERN, 2),
                                (XL, 8), (WH, 4)):
        torch.cuda.empty_cache()
        launches[f"staged {arch}"] = run_staged_phase(torch, arch, staged_layers)
        torch.cuda.empty_cache()
        launches[f"full {arch}"] = run_full_phase(torch, arch)
        log(f"chip_smoke: {arch} done at {time.perf_counter() - t_start:.1f} s")
    # gemma3's and zamba2's references check loss and grads only, B 1: see
    # run_train_reference_phase; gemma3's window cut to 128 so that S 200 is
    # longer than it; zamba2 held to the plain path in float64
    references = {PHI: {}, GRAN: {},
                  GEM: dict(n_layers=6, n_batch=1, window=128, optimizer=False),
                  ZAMBA: dict(n_layers=7, n_batch=1, optimizer=False, oracle64=True),
                  XL: dict(n_layers=8, n_batch=1, optimizer=False),
                  WH: dict(n_layers=4)}
    measured = {}
    for arch, ref_kw in references.items():
        for name, phase, kw in (("train reference", run_train_reference_phase, ref_kw),
                                ("train staged", run_train_staged_phase, {}),
                                ("train full", run_train_full_phase, {"stats": measured})):
            torch.cuda.empty_cache()
            launches[f"{name} {arch}"] = phase(torch, arch, **kw)
            log(f"chip_smoke: {name} {arch} done at {time.perf_counter() - t_start:.1f} s")
    run_cost_phase(child, measured)
    log(f"chip_smoke: cost phase done at {time.perf_counter() - t_start:.1f} s")

    torch.cuda.empty_cache()
    launches.update(run_mesh_phase(torch))
    log(f"chip_smoke: mesh phase done at {time.perf_counter() - t_start:.1f} s")

    emit(kernels_line(main_rows, launches))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
