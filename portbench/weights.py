"""Weights from a seed, made by the benchmark on the device from a layout
(``reference/layout.py``): every normally distributed leaf carved from one
buffer in the model's dtype, filled in a few large calls of one generator,
each leaf then scaled by fan_in^-1/2; norms' scales ones, biases zeros;
Mamba2's dt_bias and A_log as Mamba2 initialises them, from the same
generator. The same seed on the same device gives the same bits, so the
initial weights can be made again instead of kept."""

from __future__ import annotations

import math

import torch

from .reference.layout import flatten

CHUNK = 1 << 28          # elements a call of the generator fills
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def make(spec: dict, seed: int, device, model_dtype: str, init: dict | None = None) -> dict:
    """{path: tensor} of the layout ``spec``; the normal leaves are views of
    one contiguous buffer."""
    dtype = DTYPES[model_dtype]
    leaves = flatten(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = [(p, lf) for p, lf in leaves if lf.init == "normal"]
    total = sum(math.prod(lf.shape) for _, lf in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for off in range(0, total, CHUNK):
        flat[off:off + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for path, lf in normal:
        n = math.prod(lf.shape)
        out[path] = flat[off:off + n].view(lf.shape).mul_(lf.fan_in ** -0.5)
        off += n
    init = init or {}
    for path, lf in leaves:
        dt = torch.float32 if lf.dtype == "float32" else dtype
        if lf.init == "ones":
            out[path] = torch.ones(lf.shape, dtype=dt, device=device)
        elif lf.init == "zeros":
            out[path] = torch.zeros(lf.shape, dtype=dt, device=device)
        elif lf.init == "dt_bias":
            # dt log-uniform in [min, max], floored; dt_bias its softplus inverse
            u = torch.rand(lf.shape, generator=gen, device=device)
            lo, hi = math.log(init["time_step_min"]), math.log(init["time_step_max"])
            dtv = torch.exp(u * (hi - lo) + lo).clamp_min(init["time_step_floor"])
            out[path] = (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
        elif lf.init == "a_log":
            lo, hi = init["A_init_range"]
            u = torch.rand(lf.shape, generator=gen, device=device)
            out[path] = torch.log(u * (hi - lo) + lo).to(dt)
        elif lf.init != "normal":
            raise ValueError(f"{path}: unknown initialisation {lf.init!r}")
    return out
