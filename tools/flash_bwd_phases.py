#!/usr/bin/env python3
"""Where the bf16 flash attention backward spends its time on one CUDA card,
at phi4-mini-3.8b's training shape (B 4, S 2048, H 24, K 8, hd 128, causal).

Two readings, each printed as one JSON line with the card's name and power
limit:

- ``kernels``: the device time of each kernel one call of
  ``flash_attention_bwd_cuda`` launches (pre-pass, main kernel, cast), from
  ``torch.profiler`` over 10 calls after 3 warm-ups.
- ``phases``: cycles per (head, q tile) iteration of the main kernel, by
  phase, for thread 0 of consumer warpgroup 0, summed over every CTA. The
  tool writes a copy of ``csrc/flash_attention_bwd.cu`` into
  ``build/flash_bwd_phases/`` with ``clock64()`` reads at the points that
  ``MARKS`` names (it raises if the source no longer has one), builds it with
  the port's nvcc flags and calls it once. The reads themselves cost cycles,
  so the phases are shares of an instrumented run, not of the kernel as
  shipped.

Run from the repository root:

    python3 tools/flash_bwd_phases.py [--source COPY.cu]

(``--source`` instruments a copy of the backward instead of csrc's.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPE = (4, 2048, 24, 8, 128)
# (text in the source, phase read just before it, phase read just after it)
MARKS = [
    ("  mbar_wait(bar_kv, 0);\n", None, "wait K, V"),
    ("    mbar_wait(full(s), (i / NST) & 1);\n", "loop top", "wait Q, dO stage"),
    ("    wgmma_commit();\n    wgmma_wait<1>();\n    fence_regs(sc);\n", "issue S^T, dP^T",
     "wait S^T"),
    ("    uint32_t pp[BQ / 4];\n", "P: exp2 and mask", None),
    ("    // dV += P^T dO, dO MN-major", "P: pack", None),
    ("      wgmma_wait<1>();                          // dP^T done, dV may still run\n",
     "issue dV", "wait dP^T"),
    ("    // dK += dS^T Q, Q MN-major", "dS^T: form and store", None),
    ("    named_bar(1, 128 * NWG);\n", "issue dK", "barrier dS^T"),
    ("    wgmma_commit();\n    wgmma_wait<0>();\n", "issue dQ", "wait dV, dK, dQ"),
    ("    fence_proxy_async();\n    named_bar(2 + wg, 128);\n", "release stage, dQ store",
     "barrier dQ"),
    ("    if (++qt == qt_begin + nqt) {\n      qt = qt_begin;\n      ++h;\n    }\n  }\n",
     "hand dQ to the writer", None),
]


def instrument(src: str) -> tuple[str, list[str]]:
    """The source with a clock read at each mark, and the phase names in
    counter order."""
    names: list[str] = []

    def read(name: str) -> str:
        names.append(name)
        k = len(names) - 1
        return (f"    if (threadIdx.x == 0) {{ const long long now_ = clock64(); "
                f"s_prof[{k}] += now_ - last_; last_ = now_; }}\n")

    out = src
    for text, before, after in MARKS:
        if out.count(text) != 1:
            raise RuntimeError(f"mark not found once in the source: {text!r}")
        new = (read(before) if before else "") + text + (read(after) if after else "")
        out = out.replace(text, new)
    n = len(names)
    setup = ("  __shared__ long long s_prof[32];\n  long long last_ = clock64();\n"
             "  if (threadIdx.x == 0) for (int k = 0; k < 32; ++k) s_prof[k] = 0;\n")
    out = out.replace("  mbar_wait(bar_kv, 0);\n", setup + "  mbar_wait(bar_kv, 0);\n", 1)
    flush = (f"  if (threadIdx.x == 0) {{ atomicAdd(&g_phase[{n}], (unsigned long long)iters);\n"
             f"    for (int k = 0; k < {n}; ++k) "
             f"atomicAdd(&g_phase[k], (unsigned long long)s_prof[k]); }}\n")
    anchor = "  const int64_t k_row = (int64_t)K * HD;\n"
    if out.count(anchor) != 1:
        raise RuntimeError(f"mark not found once in the source: {anchor!r}")
    out = out.replace(anchor, flush + anchor, 1)
    out = out.replace("namespace {\n", "__device__ unsigned long long g_phase[32];\n\n"
                      "namespace {\n", 1)
    out += ('\nextern "C" int read_phases(unsigned long long* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n"
            'extern "C" int zero_phases() {\n  unsigned long long z[32] = {0};\n'
            "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n")
    return out, names


def kernel_name(key: str) -> str:
    """The function name in a profiler key such as
    ``void (anonymous namespace)::hopper::k<128, 2>(CUtensorMap_st, ...)``."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) if m else key


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None, help="a copy of csrc/flash_attention_bwd.cu")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import (_BWD_SIGNATURES, bwd_sem_count,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    B, S, H, K, hd = SHAPE
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)

    for _ in range(3):
        flash_attention_bwd_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flash_attention_bwd_cuda(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if dt > 0 and e.count >= 10:
            kernels[kernel_name(e.key)] = dt / 10 / 1e3
    print(json.dumps({"reading": "kernels", "shape": SHAPE, "device_ms_per_call": kernels,
                      "card": smi}), flush=True)

    out_dir = os.path.join(ROOT, "build", "flash_bwd_phases")
    os.makedirs(out_dir, exist_ok=True)
    source = args.source or str(kbuild.CSRC / "flash_attention_bwd.cu")
    text, names = instrument(open(source).read())
    cu, so = os.path.join(out_dir, "phases.cu"), os.path.join(out_dir, "phases.so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-o", so, cu],
                   check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(so)
    lib.flash_attention_bwd.argtypes = _BWD_SIGNATURES["flash_attention_bwd"]
    f32 = dict(dtype=torch.float32, device=dev)
    D, dq_acc = torch.empty((B, H, S), **f32), torch.empty(q.shape, **f32)
    sem = torch.empty(bwd_sem_count(B, S, H), dtype=torch.int32, device=dev)
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq_acc.data_ptr(), sem.data_ptr(),
            *(t.data_ptr() for t in outs), B, S, S, H, K, hd, 1, -1, 1, hd ** -0.5, stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    if lib.zero_phases():
        raise RuntimeError("zero_phases failed")
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    if lib.read_phases(buf):
        raise RuntimeError("read_phases failed")
    iters = buf[len(names)]
    loop = sum(buf[i] for i, n in enumerate(names) if n != "wait K, V")
    phases = {n: buf[i] / iters for i, n in enumerate(names)}
    print(json.dumps({"reading": "phases", "source": source, "shape": SHAPE,
                      "iterations": iters,
                      "cycles_per_iteration": loop / iters, "cycles": phases,
                      "share": {n: buf[i] / loop for i, n in enumerate(names)
                                if n != "wait K, V"}, "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
