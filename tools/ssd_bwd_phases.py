#!/usr/bin/env python3
"""Where the SSD intra-chunk backward spends its time on one CUDA card, at
zamba2-7b's training shape (B 4, 16 chunks, Q 128, H 112, N 64, P 64).

Two readings, each printed as one JSON line with the card's name and power
limit:

- ``kernels``: the device time of each kernel one call of
  ``ssd_intra_chunk_bwd_cuda`` launches, from ``torch.profiler`` over 10
  calls after 3 warm-ups.
- ``phases``: cycles per stage (one head a stage at this shape) of the main
  kernel, by phase and by warp, lane 0 of each warp, summed over every block,
  on the main shape's path (``dbh_full``, ``segment_full``); the compute
  warps' mean by phase and the producer warp's phases apart.
  The tool writes a copy of the source into ``build/ssd_bwd_phases/`` with
  ``clock64()`` reads at the points ``MARKS`` names (it raises if the source
  no longer has one), builds it with the port's nvcc flags and calls it
  once. The reads cost cycles of their own, so the phases are shares of an
  instrumented run, not of the kernel as shipped.

Run from the repository root:

    python3 tools/ssd_bwd_phases.py [--source COPY.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPE = (4, 16, 128, 112, 64, 64)
NWARPS, SLOTS = 12, 16         # 8 compute warps, the producer warpgroup (warp 8 works)
NCOMPUTE, PRODUCER = 8, 8
M_LOOP = ("#pragma unroll\n    for (int i = 0; i < GU; ++i) {\n      const int u = g0 + i;\n"
          "      if (u >= UE) break;\n      const int ")
# (text in the source, phase ending just before it, phase ending just after
# it); every read is a lap of one clock per warp, so a phase is the time
# since the previous read. These follow the main shape's path (dbh_full,
# segment_full) and the producer warp's stage.
MARKS = [
    ("    const float* xs = smem + lay.off_x + b * lay.xbuf;\n", "wait and barrier", None),
    ("    if (k + 1 < nstage)\n      issue_stage(g, lay, smem, k + 1, threadIdx.x - 32 * NCOMPUTE,"
     " NTHREADS - 32 * NCOMPUTE);\n", "wait and barrier", "producer: copies"),
    ("      dbh_full(ln, 2 * pw + 1, xs, dsts, Ws + hp * Qp, dbs + NT * 32);\n", None,
     "producer: dBh"),
    ("    cp_async_wait_all();\n", "producer: L scan, dL", "producer: wait for copies"),
    ("      if constexpr (C0F == MAXU) {\n", "setup", None),
    ("  const float2 Lsa = L[sa], Lsb = L[sb];\n", "(w B) dstate^T and E", None),
    (M_LOOP + "ta = ", "dM^T", None),
    (M_LOOP + "tr = ", "M, dCB, G sums", None),
    ("  csa = quad_sum(csa);\n", "M^T dy", None),
    ("  if (ROLE == 0) {\n", "column sums", None),
    ("    } else {\n    if (st.a) {\n", "hand-over, dx store", None),
    ("  }\n  __syncthreads();\n\n  // this block's partials", "end of stage", None),
]
# the end of each stage loop (compute, producer), where the counters are
# flushed
ENDS = ["  __syncthreads();\n\n  // this block's partials",
        "  __syncthreads();\n  if (warp == PRODUCER) {\n    const int hp = (hg - 1) & 1;"]
START = "  for (int k = 0; k < nstage; ++k) {\n"


def instrument(src: str) -> tuple[str, list[str]]:
    """The source with a clock read at each mark, and the phase names in
    counter order (a name met twice shares its counter)."""
    names: list[str] = []

    def read(name: str) -> str:
        if name not in names:
            names.append(name)
        k = names.index(name)
        return ("    if ((threadIdx.x & 31) == 0) { const long long now_ = clock64(); "
                f"s_prof[threadIdx.x >> 5][{k}] += now_ - s_last[threadIdx.x >> 5]; "
                "s_last[threadIdx.x >> 5] = now_; }\n")

    out = src
    for text, before, after in MARKS:
        if out.count(text) != 1:
            raise RuntimeError(f"mark not found once in the source: {text!r}")
        out = out.replace(text, (read(before) if before else "") + text +
                          (read(after) if after else ""))
    if out.count(START) != 2:
        raise RuntimeError("the two stage loops were not found")
    setup = ("  if (lane == 0) {\n"
             f"    for (int k_ = 0; k_ < {SLOTS}; ++k_) s_prof[warp][k_] = 0;\n"
             "    s_last[warp] = clock64();\n  }\n")
    out = out.replace(START, setup + START)
    flush = ("  if (lane == 0) {\n"
             f"    for (int k_ = 0; k_ < {len(names)}; ++k_) "
             f"atomicAdd(&g_phase[warp * {SLOTS} + k_], (unsigned long long)s_prof[warp][k_]);\n"
             f"    atomicAdd(&g_phase[{NWARPS * SLOTS} + warp], (unsigned long long)nstage);\n"
             "  }\n")
    for end in ENDS:
        if out.count(end) != 1:
            raise RuntimeError(f"loop end not found once: {end!r}")
        out = out.replace(end, end.replace("  __syncthreads();\n", "  __syncthreads();\n" + flush))
    size = NWARPS * SLOTS + NWARPS
    out = out.replace("namespace {\n", f"__device__ unsigned long long g_phase[{size}];\n"
                      f"__shared__ long long s_prof[{NWARPS}][{SLOTS}];\n"
                      f"__shared__ long long s_last[{NWARPS}];\n\nnamespace {{\n", 1)
    out += ('\nextern "C" int read_phases(unsigned long long* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n"
            'extern "C" int zero_phases() {\n'
            f"  unsigned long long z[{size}] = {{0}};\n"
            "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n")
    return out, names


def kernel_name(key: str) -> str:
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) if m else key


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None, help="a copy of csrc/ssd_intra_chunk_bwd.cu")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd_scan import (_BWD_SIGNATURES, bwd_heads_per_block,
                                              ssd_intra_chunk_bwd_cuda)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    Bs, nc, Q, H, N, P = SHAPE
    g = torch.Generator(device=dev).manual_seed(3)
    ins = [-F.softplus(torch.randn((Bs, nc, Q, H), generator=g, device=dev))]
    ins += [torch.randn(s, generator=g, device=dev)
            for s in ((Bs, nc, Q, 1, N), (Bs, nc, Q, 1, N), (Bs, nc, Q, H, P), (Bs, nc, Q, H, P),
                      (Bs, nc, H, P, N), (Bs, nc, H))]

    for _ in range(3):
        ssd_intra_chunk_bwd_cuda(*ins)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd_intra_chunk_bwd_cuda(*ins)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if dt > 0 and e.count >= 10:
            kernels[kernel_name(e.key)] = dt / 10 / 1e3
    print(json.dumps({"reading": "kernels", "shape": SHAPE, "device_ms_per_call": kernels,
                      "card": smi}), flush=True)

    out_dir = os.path.join(ROOT, "build", "ssd_bwd_phases")
    os.makedirs(out_dir, exist_ok=True)
    source = args.source or str(kbuild.CSRC / "ssd_intra_chunk_bwd.cu")
    text, names = instrument(open(source).read())
    cu, so = os.path.join(out_dir, "phases.cu"), os.path.join(out_dir, "phases.so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-o", so, cu],
                   check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(so)
    lib.ssd_intra_chunk_bwd.argtypes = _BWD_SIGNATURES["ssd_intra_chunk_bwd"]
    BC = Bs * nc
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    hg = bwd_heads_per_block(BC, H, n_sm)
    ngrp = math.ceil(H / hg)
    outs = [torch.empty_like(t) for t in (ins[0], ins[1], ins[2], ins[3])]
    scratch = [torch.empty((BC, ngrp, Q, Q), device=dev), torch.empty((BC, ngrp, Q, N), device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        dla, dC, dB, dx = outs
        err = lib.ssd_intra_chunk_bwd(*(t.data_ptr() for t in ins),
                                      *(t.data_ptr() for t in (dla, dx, dC, dB, *scratch)),
                                      BC, Q, H, 1, N, P, hg, stream)
        if err:
            raise RuntimeError(f"ssd_intra_chunk_bwd: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    if lib.zero_phases():
        raise RuntimeError("zero_phases failed")
    call()
    torch.cuda.synchronize()
    size = NWARPS * SLOTS + NWARPS
    buf = (ctypes.c_ulonglong * size)()
    if lib.read_phases(buf):
        raise RuntimeError("read_phases failed")
    per_warp = {}
    for w in range(NWARPS):
        stages = buf[NWARPS * SLOTS + w]
        per_warp[w] = {n: buf[w * SLOTS + i] / stages for i, n in enumerate(names)
                       if buf[w * SLOTS + i]}
    compute = range(NCOMPUTE)
    mean = {n: sum(per_warp[w].get(n, 0.0) for w in compute) / len(compute) for n in names
            if not n.startswith("producer")}
    total = sum(mean.values())
    print(json.dumps({"reading": "phases", "source": source, "shape": SHAPE,
                      "heads_per_block": hg, "cycles_per_stage": total,
                      "compute_share": {n: v / total for n, v in mean.items()},
                      "producer": per_warp[PRODUCER],
                      "cycles_by_warp": per_warp, "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
