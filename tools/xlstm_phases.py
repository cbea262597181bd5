#!/usr/bin/env python3
"""Where xlstm-1.3b's time goes on the card, one layer at a time, at the
widths and batch shapes ``chip_smoke.py`` serves and trains it with:

  slstm prefill   one sLSTM block (bf16 weights, float32 state) over a
                  prompt of 512 at B 8, under ``inference_mode``: the
                  per-token loop of one set of launches a step
  slstm train     one sLSTM block's forward and backward at B 4, S 2048
  mlstm prefill   one mLSTM layer at B 8, prompt 512 (4 chunks of 128)
  mlstm train     one mLSTM layer's forward and backward at B 4, S 2048
  mlstm decode    one mLSTM layer's decode step at B 8 from a filled state
                  (C: 8 x 4 x 1024 x 1024 float32, 134 MB), beside the least
                  time for reading and writing C once at 3.35 TB/s

For each: host-clock wall ms (ending in a synchronise), device busy ms and
idle share and the launch count from torch.profiler (as
``repro_torch.launch.profile.profile_window`` reads a window), and what the
model's run holds of them (6 sLSTM and 42 mLSTM layers serving, 2 and 14 in
the 16-layer training cut). Prints one JSON line each, then the card's name
and power limit. Run from the repository root:

    python3 tools/xlstm_phases.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.profile import profile_window
    from repro_torch.models import xlstm, xlstm_model
    dev = resolve_device("cuda")
    cfg = get_config("xlstm-1.3b")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    sp = xlstm.slstm_init(gen, cfg, dtype=bf16)
    mp = xlstm_model._m_layer_init(gen, cfg, bf16)
    serve_n = {"slstm": cfg.n_layers // cfg.slstm_period}
    serve_n["mlstm"] = cfg.n_layers - serve_n["slstm"]
    train_n = {"slstm": 2, "mlstm": 14}

    def x_of(B, S, grad=False):
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(bf16)
        return x.requires_grad_(grad)

    def train(fn, params, x):
        leaves = [t.requires_grad_() for t in _leaves(params) if t.is_floating_point()]

        def run():
            y = fn(params, x)
            torch.autograd.grad(y.float().square().mean(), leaves + [x])
        return run

    x8, x4 = x_of(8, 512), x_of(4, 2048, grad=True)
    windows = {
        "slstm prefill": (lambda: _infer(lambda: xlstm.slstm_forward(sp, x8, cfg)), serve_n,
                          "slstm", {"B": 8, "S": 512}),
        "mlstm prefill": (lambda: _infer(lambda: xlstm_model._m_layer(mp, x8, cfg)), serve_n,
                          "mlstm", {"B": 8, "S": 512}),
        "slstm train": (train(lambda p, x: xlstm.slstm_forward(p, x, cfg)[0], sp, x4), train_n,
                        "slstm", {"B": 4, "S": 2048}),
        "mlstm train": (train(lambda p, x: xlstm_model._m_residual(p, x, cfg), mp, x4), train_n,
                        "mlstm", {"B": 4, "S": 2048}),
    }
    out = {}
    for name, (fn, counts, kind, shape) in windows.items():
        fn()                                                   # warm-up
        row = profile_window(fn, dev, 6)
        out[name] = {"window": name, **shape, "layers_in_model": counts[kind],
                     **{k: row[k] for k in ("unprofiled_wall_ms", "device_busy_ms",
                                            "idle_share", "kernel_launches",
                                            "device_ms_by_category", "top_kernels_ms")}}
        print(json.dumps(out[name]), flush=True)

    # one mLSTM layer's decode step from a filled state
    with torch.inference_mode():
        cache = xlstm.empty_mlstm_cache(cfg, 8, bf16, dev)
        _, state = xlstm_model._m_layer(mp, x8, cfg)
        for dst, src in zip(cache, state):
            dst.copy_(src)
        x1 = x8[:, -1:].contiguous()
        step = lambda: xlstm_model._m_layer(mp, x1, cfg, cache=cache)   # noqa: E731
        step()
        row = profile_window(step, dev, 6)
    c_bytes = cache.C.numel() * cache.C.element_size()
    print(json.dumps({
        "window": "mlstm decode", "B": 8, "state_C_bytes": c_bytes,
        "layers_in_model": serve_n["mlstm"],
        "state_floor_ms": 2 * c_bytes / HBM_BYTES_PER_S * 1e3,
        **{k: row[k] for k in ("unprofiled_wall_ms", "device_busy_ms", "idle_share",
                               "kernel_launches", "device_ms_by_category",
                               "top_kernels_ms")}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    return 0


def _infer(fn):
    import torch
    with torch.inference_mode():
        fn()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
