"""Cells of the benchmark cut to a size a CPU test holds: the published
family and code path at smoke widths, a short corpus, and limits set at
that size as each cell's own were at its size: between the largest
reading of a sound run on the CPU over 12 seeds and the smallest of the
control and of half a batch left out over 4 (the same numbers compared)."""

from __future__ import annotations

import dataclasses

from portbench.harness import Cell

SMOKE = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=512),
}

LIMITS = {
    "dense": {"loss_gap": 1e-3, "grad_gap": 6e-3, "change_gap": 5e-3},
}


def small_cell(name: str, dtype: str | None = None) -> Cell:
    cell = Cell.load(name)
    cfg = {**cell.config, **SMOKE[cell.config["family"]]}
    if dtype:
        cfg["dtype"] = dtype
    tr = {**cell.traffic, "batch": 2, "seq": 64, "max_steps_per_s": 400, "shard_tokens": 4096,
          "documents": {**cell.traffic["documents"], "median_tokens": 40, "min_tokens": 4,
                        "max_tokens": 200}}
    return dataclasses.replace(cell, config=cfg, traffic=tr,
                               limits=LIMITS[cfg["family"]])
