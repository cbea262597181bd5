"""Dry-run: trace every (arch x shape) cell's sharded step on a fake world
of the production mesh, and write its roofline terms, collectives and
memory. The port of ``src/repro/launch/dryrun.py``.

Nothing is computed and no device is needed: params, optimizer state,
caches and batches are fake tensors (``FakeTensorMode``, CPU fakes, so
``kernels.ops`` takes the plain versions, as ``repro``'s dry-run lowers its
reference path), the world is a fake process group
(``launch.mesh.init_fake_world``: this process is rank 0 of 256, or 512
with ``--multi-pod``), and the step runs in eager Python under the
counters of ``runtime/costs.py``, then once more under ``MemTracker``
(DTensor's sharding propagation, which makes global-shape fakes in the
active fake mode, then answers from its cache). Per cell:

* ``alg_*``: ``step_costs`` of the one-device step (``make_*``), global;
  the terms divide it by the ranks, as ``repro`` does;
* ``collectives``: ``collective_bytes`` of the sharded step (``shard_*``),
  one rank's result bytes by kind;
* ``memory``: ``argument_bytes``, the rank's local shards of state (or
  params and cache) and batch, each with storage of its own; ``temp_bytes``,
  the high-water mark of the bytes the step allocates beyond them;
  ``peak_ok_hbm``, their sum against the H100's memory;
* ``trace_s``: the time taken to build and run the step on fakes
  (``repro``'s ``compile_s``; XLA's own cost analysis has no counterpart).

Usage:
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all                # every cell
  python -m repro_torch.launch.dryrun ... --multi-pod           # (2,16,16) mesh
  python -m repro_torch.launch.dryrun ... --variant zero1=off,remat=full

Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from ..configs import ShapeSpec, get_config, shapes_for
from ..configs.base import ModelConfig
from ..core.perfmodel import H100
from ..models import build_model
from ..models.layers import dtype_of
from ..runtime import (
    RuntimeConfig,
    distribute_tree,
    make_decode_step,
    make_prefill,
    make_train_state,
    make_train_step,
    shard_decode_step,
    shard_prefill,
    shard_train_step,
)
from ..runtime.costs import collective_bytes, step_costs
from .mesh import init_fake_world, make_production_mesh


def parse_variant(s: str) -> dict:
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, _, v = kv.partition("=")
        out[k.strip()] = v.strip()
    return out


def runtime_from_variant(var: dict, shape_kind: str) -> RuntimeConfig:
    # default for train cells: accum=4 (activation memory / 4)
    rt = RuntimeConfig(accum=4 if shape_kind == "train" else 1)
    if "remat" in var:
        rt = dataclasses.replace(rt, remat=None if var["remat"] == "none" else var["remat"])
    if "accum" in var:
        rt = dataclasses.replace(rt, accum=int(var["accum"]))
    if var.get("zero1") == "off":
        rt = dataclasses.replace(rt, zero1=False)
    if var.get("compress") == "on":
        rt = dataclasses.replace(rt, compress_grads=True)
    flags = tuple(k for k in ("moe2d", "dp_decode", "accbf16", "bf16bwd") if var.get(k) == "on")
    if flags:
        rt = dataclasses.replace(rt, flags=flags)
    return rt


def _pad16(n: int) -> int:
    return ((n + 15) // 16) * 16


def config_from_variant(arch, var: dict):
    """Variant-level config transforms (beyond-paper structural changes);
    ``arch`` is an arch id or a ``ModelConfig``."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if var.get("padheads") == "on":
        # pad query heads to a multiple of the model axis so attention stays
        # head-sharded (zero wo rows for pad heads make this exact in prod)
        cfg = dataclasses.replace(cfg, n_heads=_pad16(cfg.n_heads))
    if "capacity" in var:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(var["capacity"]))
    return cfg


def batch_like(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The cell's batch (``repro``'s ``input_specs``), as tensors of the
    active (fake) mode: int64 tokens, a VLM's patch prefix and Whisper's
    frames in the model's dtype, one token a row for decode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": torch.zeros((B,), dtype=torch.long)}
    out = {"tokens": torch.zeros((B, S), dtype=torch.long)}
    if shape.kind == "train":
        out["labels"] = torch.zeros((B, S), dtype=torch.long)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model), dtype=dtype_of(cfg))
    if cfg.family == "audio":
        out["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dtype_of(cfg))
    return out


def _laid_out(mesh, tree, specs):
    """``distribute_tree``, each local shard then given storage of its own
    (``distribute_tensor`` slices the full tensor, whose storage a memory
    count would otherwise charge to every rank)."""
    def own(t):
        return DTensor.from_local(t.to_local().clone(), t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape, stride=t.stride())
    return pytree.tree_map_only(DTensor, own, distribute_tree(mesh, tree, specs))


def lower_cell(arch, shape: ShapeSpec, mesh, rt: RuntimeConfig, var=None):
    """Build the cell's sharded step on fakes. ``arch`` is an arch id or a
    ``ModelConfig`` (a cut config). Must run inside a ``FakeTensorMode``.
    Returns (run, args, algorithmic_costs): ``run()`` takes the sharded step
    once on ``args``, the rank's local shards (state, or params and cache,
    and batch)."""
    cfg = config_from_variant(arch, var or {})
    model = build_model(cfg)
    batch = batch_like(cfg, shape)
    gen = torch.Generator().manual_seed(0)

    if shape.kind == "train":
        state = make_train_state(model, gen, rt)
        alg = step_costs(make_train_step(model, rt), state, batch)
        step, st_sh, b_sh = shard_train_step(model, mesh, rt, state, batch)
        args = (_laid_out(mesh, state, st_sh), _laid_out(mesh, batch, b_sh))
    elif shape.kind == "prefill":
        params = model.init(gen)
        # VLM prompts carry a patch-embedding prefix on top of seq_len
        s_max = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
        cache_like = model.init_cache(shape.global_batch, s_max, "cpu")
        alg = step_costs(make_prefill(model, s_max, rt), params, batch)
        step, p_sh, b_sh, _ = shard_prefill(model, mesh, rt, s_max, params, batch, cache_like)
        args = (_laid_out(mesh, params, p_sh), _laid_out(mesh, batch, b_sh))
    else:  # decode: one token against a seq_len-deep cache
        params = model.init(gen)
        cache = model.init_cache(shape.global_batch, shape.seq_len, "cpu")
        alg = step_costs(make_decode_step(model, rt), params, cache, batch)
        step, p_sh, c_sh, b_sh = shard_decode_step(model, mesh, rt, params, cache, batch)
        args = (_laid_out(mesh, params, p_sh), _laid_out(mesh, cache, c_sh),
                _laid_out(mesh, batch, b_sh))
    return (lambda: step(*args)), args, alg


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def run_cell(arch, shape: ShapeSpec, *, multi_pod: bool = False, variant: str = "",
             out_dir: str = "artifacts/dryrun_torch", mesh=None) -> dict:
    """Dry-run one cell in this process's fake world and write its record.
    ``arch`` is an arch id or a ``ModelConfig``; ``mesh`` defaults to the
    production mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              device_type="cpu")
    chips = mesh.size()
    var = parse_variant(variant)
    rt = runtime_from_variant(var, shape.kind)
    cfg = config_from_variant(arch, var)
    name = arch if isinstance(arch, str) else arch.name
    t0 = time.time()

    def total(snapshot) -> int:
        return sum(int(d["Total"]) for d in snapshot.values())

    with FakeTensorMode():
        run, args, alg = lower_cell(cfg, shape, mesh, rt)
        coll = collective_bytes(run)             # per device
        mem = MemTracker()                       # the second run (module docstring)
        mem.track_external(*(t.to_local() if hasattr(t, "to_local") else t
                             for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)))
        arg_bytes = total(mem.get_tracker_snapshot("current"))
        with mem:
            run()
    t_trace = time.time() - t0
    temp = total(mem.get_tracker_snapshot("peak")) - arg_bytes

    # algorithmic flops/bytes are GLOBAL; divide by chips.
    flops_dev = alg["flops"] / chips
    # memory term: dot operand/result traffic is the post-fusion floor of HBM
    # bytes; the all-ops estimate is the no-fusion ceiling.
    dot_bytes_dev = alg["dot_bytes"] / chips
    bytes_dev = alg["bytes"] / chips
    comm = sum(v for k, v in coll.items() if k != "count")

    hw = H100
    terms = {
        "compute_s": flops_dev / hw.peak_flops_bf16,
        "memory_s": dot_bytes_dev / hw.hbm_bw,
        "memory_s_upper": bytes_dev / hw.hbm_bw,
        "collective_s": comm / hw.nvlink_bw,
        "collective_bytes_per_dev": comm,
    }

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1
    )
    mult = 6 if shape.kind == "train" else 2
    model_flops_global = mult * n_active * tokens
    model_flops_per_dev = model_flops_global / chips

    dominant = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    )
    bound_s = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    rec = {
        "arch": name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": _mesh_name(mesh),
        "chips": chips,
        "hw": hw.name,
        "variant": variant or "baseline",
        "trace_s": round(t_trace, 1),
        "alg_flops_global": alg["flops"],
        "alg_bytes_global": alg["bytes"],
        "alg_dot_bytes_global": alg["dot_bytes"],
        "collectives": coll,
        "terms": terms,
        "dominant": dominant,
        # fraction of roofline if the dominant term were perfectly overlapped
        "roofline_fraction": (terms["compute_s"] / bound_s) if bound_s else None,
        "model_flops_global": model_flops_global,
        "model_flops_per_dev": model_flops_per_dev,
        "useful_flops_ratio": model_flops_global / alg["flops"] if alg["flops"] else None,
        "params": n_params,
        "active_params": n_active,
        "memory": {
            "argument_bytes": arg_bytes,
            "temp_bytes": temp,
            "peak_ok_hbm": arg_bytes + temp < hw.hbm_bytes,
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant.replace('=', '-').replace(',', '_')}" if variant else ""
    fname = f"{name}__{shape.name}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="arch id or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS

    init_fake_world(512 if args.multi_pod else 256)
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    failures = []
    for arch in archs:
        for shape in shapes_for(arch):
            if args.shape != "all" and shape.name != args.shape:
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                               variant=args.variant, out_dir=args.out)
                t = rec["terms"]
                m = rec["memory"]
                print(
                    f"OK  {arch:22s} {shape.name:12s} {rec['mesh']:8s} "
                    f"trace={rec['trace_s']}s "
                    f"comp={t['compute_s']*1e3:.2f}ms mem={t['memory_s']*1e3:.2f}ms "
                    f"coll={t['collective_s']*1e3:.2f}ms dom={rec['dominant']} "
                    f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'],3)} "
                    f"peak={(m['argument_bytes'] + m['temp_bytes']) / 1e9:.2f}GB",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch, shape.name, repr(e)))
                traceback.print_exc()
                print(f"FAIL {arch} {shape.name}: {e}", flush=True)
    if failures:
        print(f"{len(failures)} failures:", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
