"""gloo worlds on the CPU for ``tests/test_torch_mesh.py`` (a helper, not a
test file): each world is one set of processes that runs several cases of
the port's mesh layer and writes each rank's results to a file.

Imports torch and ``repro_torch`` only, so the spawned ranks never load JAX.
Every rank builds the same full params from the same seeded generator,
lays them out with ``runtime.parallel.distribute_tree``, and holds the
sharded steps against the port's single-device steps, which it runs
itself on the same full tensors.
"""

from __future__ import annotations

import datetime
import math
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEED_PARAMS, SEED_BATCH, SEED_INT8 = 0, 1, 100
INT8_SHAPE = (37, 29)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(a, b) -> float:
    a, b = _full(a).float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _tree_rel(a, b) -> float:
    from repro_torch.optim.adamw import leaves
    return max(_rel(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


def _batch(cfg, B: int, S: int, labels: bool = True) -> dict:
    g = torch.Generator().manual_seed(SEED_BATCH)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return out


def checksum(tree) -> float:
    """A float64 checksum of a tree's values, sensitive to their order."""
    from repro_torch.optim.adamw import leaves
    total = 0.0
    for i, t in enumerate(leaves(tree)):
        w = torch.arange(1, t.numel() + 1, dtype=torch.float64) / t.numel()
        total += float((t.detach().reshape(-1).double() * w).sum()) * (i + 1)
    return total


# -- world "train": (data 4, model 2), phi4 smoke ------------------------------
def _train_world(rank: int) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import compression
    from repro_torch.runtime import parallel as par

    mesh = make_smoke_mesh(4, 2, "cpu")
    cfg = get_smoke("phi4-mini-3.8b")
    model = build_model(cfg)
    batch = _batch(cfg, 8, 32)
    out = {}
    for name, compress in (("train", False), ("train_int8", True)):
        rt = par.RuntimeConfig(remat=None, zero1=True, accum=2, compress_grads=compress)
        ref = par.make_train_state(model, torch.Generator().manual_seed(SEED_PARAMS), rt)
        state = par.make_train_state(model, torch.Generator().manual_seed(SEED_PARAMS), rt)
        step, st_sh, _ = par.shard_train_step(model, mesh, rt, state, batch)
        if name == "train":       # what each rank is about to distribute
            sums = [None] * dist.get_world_size()
            dist.all_gather_object(sums, checksum(state.params))
            out["checksum"] = sums
        state = par.distribute_tree(mesh, state, st_sh)
        ref_step = par.make_train_step(model, rt)
        losses, ref_losses, perr = [], [], []
        for _ in range(2):
            ref, m_ref = ref_step(ref, batch)
            state, m = step(state, batch)
            losses.append(float(_full(m["loss"])))
            ref_losses.append(float(m_ref["loss"]))
            perr.append(_tree_rel(state.params, ref.params))
        m_leaf = state.opt.m["layers"]["mlp"]["gate"]["w"]
        out[name] = {"losses": losses, "ref_losses": ref_losses, "param_err": perr,
                     "m_placements": [repr(p) for p in m_leaf.placements],
                     "p_placements": [repr(p) for p in
                                      state.params["layers"]["mlp"]["gate"]["w"].placements]}

    # int8_allreduce over the "data" group (4 ranks), payload dtypes spied on
    group = mesh.get_group("data")
    x = int8_input(mesh.get_local_rank("data"))
    seen = []
    saved = dist.all_to_all_single, dist.all_gather_into_tensor

    def spy(fn, name):
        def run(a, b, *args, **kwargs):
            seen.append((name, str(a.dtype), str(b.dtype)))
            return fn(a, b, *args, **kwargs)
        return run
    dist.all_to_all_single = spy(saved[0], "all_to_all_single")
    dist.all_gather_into_tensor = spy(saved[1], "all_gather_into_tensor")
    try:
        y = compression.int8_allreduce(x, group)
    finally:
        dist.all_to_all_single, dist.all_gather_into_tensor = saved
    out["int8_allreduce"] = {"y": y.numpy(), "calls": seen,
                             "model_rank": mesh.get_local_rank("model")}
    return out


def int8_input(i: int) -> torch.Tensor:
    return torch.randn(INT8_SHAPE, generator=torch.Generator().manual_seed(SEED_INT8 + i))


# -- world "serve": (data 2, model 4), qwen3 smoke ----------------------------
def _serve_world(rank: int) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import parallel as par

    mesh = make_smoke_mesh(2, 4, "cpu")
    cfg = get_smoke("qwen3-14b")         # 4 q heads, 2 KV heads: KV stays replicated
    model = build_model(cfg)
    B, S, S_max, steps = 4, 14, 32, 3    # decode crosses from rank 1's rows into rank 2's
    params = model.init(torch.Generator().manual_seed(SEED_PARAMS))
    batch = _batch(cfg, B, S, labels=False)
    rt = par.RuntimeConfig()

    ref_logits, ref_cache = model.prefill(params, batch, S_max)
    cache_like = model.init_cache(B, S_max, "cpu")
    pre, p_sh, _, c_sh = par.shard_prefill(model, mesh, rt, S_max, params, batch, cache_like)
    dec, _, _, _ = par.shard_decode_step(model, mesh, rt, params, cache_like,
                                         {"token": batch["tokens"][:, 0]})
    dparams = par.distribute_tree(mesh, params, p_sh)
    logits, cache = pre(dparams, batch)
    storage = cache_storage(cache)
    errs, tokens_equal, pos = [_rel(logits, ref_logits)], [], [int(_full(cache["pos"]))]
    for _ in range(steps):
        tok = ref_logits.argmax(-1)
        tokens_equal.append(bool((_full(logits).argmax(-1) == tok).all()))
        ref_logits, ref_cache = model.decode_step(params, ref_cache, {"token": tok})
        logits, cache = dec(dparams, cache, {"token": tok})
        errs.append(_rel(logits, ref_logits))
        pos.append(int(_full(cache["pos"])))
    k_cache_err = _rel(cache["k"], ref_cache["k"])
    return {"decode": {"errs": errs, "tokens_equal": tokens_equal, "pos": pos,
                       "cache_err": k_cache_err, "cache_storage": storage,
                       "k_placements": [repr(p) for p in cache["k"].placements],
                       "ref_pos": int(ref_cache["pos"])}}


# -- world "moe": (data 2, model 2), qwen3-moe smoke --------------------------
def _moe_world(rank: int) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke
    from repro_torch.hints import mesh_hint
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime import sharding as sh

    mesh = make_smoke_mesh(2, 2, "cpu")
    cfg = get_smoke("qwen3-moe-30b-a3b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED_PARAMS))
    batch = _batch(cfg, 2, 64)
    ref_loss, _, ref_g = par.loss_and_grads(model, tree_map(torch.clone, params), batch)
    out = {}
    grads = {}
    for variant in ("baseline", "moe2d"):
        flags = () if variant == "baseline" else ("moe2d",)
        dparams = par.distribute_tree(mesh, params, sh.param_shardings(mesh, params))
        dbatch = par.distribute_tree(mesh, batch, sh.batch_shardings(mesh, batch))
        with mesh_hint(mesh, flags), implicit_replication():
            loss, _, g = par.loss_and_grads(model, dparams, dbatch)
        grads[variant] = tree_map(_full, g)
        out[variant] = {"loss": float(_full(loss)), "ref_loss": float(ref_loss),
                        "grad_err": _tree_rel(g, ref_g)}
    from repro_torch.optim.adamw import leaves
    out["variants"] = {
        "loss_diff": abs(out["baseline"]["loss"] - out["moe2d"]["loss"]),
        "grad_abs_diff": max(float((a - b).abs().max()) for a, b in
                             zip(leaves(grads["baseline"]), leaves(grads["moe2d"])))}

    B, S, S_max = 2, 12, 16
    sbatch = _batch(cfg, B, S, labels=False)
    rt = par.RuntimeConfig(flags=("dp_decode",))
    ref_logits, ref_cache = model.prefill(params, sbatch, S_max)
    cache_like = model.init_cache(B, S_max, "cpu")
    pre, p_sh, _, _ = par.shard_prefill(model, mesh, rt, S_max, params, sbatch, cache_like)
    dec, dp_sh, _, _ = par.shard_decode_step(model, mesh, rt, params, cache_like,
                                             {"token": sbatch["tokens"][:, 0]})
    _, cache = pre(par.distribute_tree(mesh, params, p_sh), sbatch)
    rparams = par.distribute_tree(mesh, params, dp_sh)
    errs = []
    for _ in range(2):
        tok = ref_logits.argmax(-1)
        ref_logits, ref_cache = model.decode_step(params, ref_cache, {"token": tok})
        logits, cache = dec(rparams, cache, {"token": tok})
        errs.append(_rel(logits, ref_logits))
    out["refusals"] = _refusals(mesh)
    out["local_kernels"] = _local_kernels(mesh)
    out["dp_decode"] = {"errs": errs,
                        "replicated": all(all(repr(p) == "Replicate()" for p in t.placements)
                                          for t in leaves(rparams))}
    return out


def _local_kernels(mesh) -> dict:
    """Forward and backward on local shards against the plain versions on
    the full tensors: flash attention with q's heads over "model" and the
    one KV head replicated (each rank picks its KV head; k/v's grads are
    partial sums), ssd_intra_chunk with batch over "data" and heads over
    "model" (C/B replicated there, their grads partial sums)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain

    def run(fn, plain, full, placements):
        leaves = [t.clone().requires_grad_() for t in full]
        want = plain(*leaves)
        want = want if isinstance(want, tuple) else (want,)
        wgrads = torch.autograd.grad(sum(w.sum() * (i + 1) for i, w in enumerate(want)), leaves)
        dts = [distribute_tensor(t, mesh, p, src_data_rank=None).requires_grad_()
               for t, p in zip(full, placements)]
        got = fn(*dts)
        got = got if isinstance(got, tuple) else (got,)
        ggrads = torch.autograd.grad(sum(g.sum() * (i + 1) for i, g in enumerate(got)), dts)
        return {"out": max(_rel(g, w) for g, w in zip(got, want)),
                "grad": max(_rel(g, w) for g, w in zip(ggrads, wgrads))}

    g = torch.Generator().manual_seed(8)
    qkv = [torch.randn(s, generator=g) for s in [(2, 8, 4, 16), (2, 8, 1, 16), (2, 8, 1, 16)]]
    kv_pl = [Shard(0), Replicate()]
    out = {"flash": run(ops.flash_attention, flash_attention_plain, qkv,
                        [[Shard(0), Shard(2)], kv_pl, kv_pl])}
    B, nc, Q, H, N, P = 2, 2, 8, 4, 4, 4
    ssd = [-torch.rand((B, nc, Q, H), generator=g) * 0.1,
           torch.randn((B, nc, Q, 1, N), generator=g), torch.randn((B, nc, Q, 1, N), generator=g),
           torch.randn((B, nc, Q, H, P), generator=g)]
    heads = [Shard(0), Shard(3)]
    out["ssd"] = run(ops.ssd_intra_chunk, ssd_intra_chunk_plain, ssd,
                     [heads, kv_pl, kv_pl, heads])
    return out


def _refusals(mesh) -> dict:
    """What the kernel entry points say to placements with no exact local
    form: q's sequence sharded for flash attention, a window over a
    sequence-sharded cache for decode."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn(s, generator=g) for s in [(2, 8, 4, 16), (2, 8, 2, 16)])
    out = {}
    try:
        ops.flash_attention(distribute_tensor(q, mesh, [Shard(0), Shard(1)], src_data_rank=None),
                            distribute_tensor(k, mesh, [Shard(0), Replicate()], src_data_rank=None),
                            distribute_tensor(k, mesh, [Shard(0), Replicate()], src_data_rank=None))
        out["flash"] = None
    except ValueError as e:
        out["flash"] = str(e)
    kc = distribute_tensor(k, mesh, [Shard(0), Shard(1)], src_data_rank=None)
    try:
        with torch.no_grad():
            ops.decode_attention(
                distribute_tensor(q[:, :1], mesh, [Shard(0), Replicate()], src_data_rank=None),
                kc, kc, kv_len=torch.tensor(5, dtype=torch.int32), window=4)
        out["decode_window"] = None
    except ValueError as e:
        out["decode_window"] = str(e)
    return out


# -- world "families": (data 2, model 2), the five families past dense and MoE --
FAMILIES = ("zamba2-7b", "xlstm-1.3b", "whisper-tiny", "gemma3-12b", "internvl2-2b")
# head counts that "model" (2) does not divide: the flat projections' shards
# would split heads, so they are made whole first (attention.split_heads, _flat)
UNEVEN = {"phi4-mini-3.8b": {"n_heads": 3, "n_kv_heads": 1}, "xlstm-1.3b": {"n_heads": 1, "n_kv_heads": 1},
          "whisper-tiny": {"n_heads": 3, "n_kv_heads": 3}}
CASES = FAMILIES + tuple(f"{arch} uneven" for arch in UNEVEN)
FAM_B, FAM_S, FAM_GEN = 4, 40, 3     # gemma3's 40-token prompt wraps its 32-slot ring


def _inputs(cfg, B: int) -> dict:
    """The VLM's patch prefix and Whisper's frames, seeded: the same on
    every rank."""
    g = torch.Generator().manual_seed(SEED_BATCH + 1)
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn((B, cfg.n_patches, cfg.d_model), generator=g)}
    if cfg.family == "audio":
        return {"frames": torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g)}
    return {}


def _family(case: str, mesh) -> dict:
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import parallel as par

    arch, _, uneven = case.partition(" ")
    cfg = get_smoke(arch)
    if uneven:
        cfg = dataclasses.replace(cfg, **UNEVEN[arch])
    model = build_model(cfg)
    out = {}
    batch = {**_batch(cfg, FAM_B, FAM_S), **_inputs(cfg, FAM_B)}
    rt = par.RuntimeConfig(remat=None, zero1=True, schedule="constant",
                           opt=AdamWConfig(lr=1e-3))
    ref = par.make_train_state(model, torch.Generator().manual_seed(SEED_PARAMS), rt)
    state = par.make_train_state(model, torch.Generator().manual_seed(SEED_PARAMS), rt)
    step, st_sh, _ = par.shard_train_step(model, mesh, rt, state, batch)
    state = par.distribute_tree(mesh, state, st_sh)
    ref_step = par.make_train_step(model, rt)
    losses, ref_losses = [], []
    for _ in range(2):
        ref, m_ref = ref_step(ref, batch)
        state, m = step(state, batch)
        losses.append(float(_full(m["loss"])))
        ref_losses.append(float(m_ref["loss"]))
    out["train"] = {"losses": losses, "ref_losses": ref_losses}

    prompt = {**_batch(cfg, FAM_B, FAM_S, labels=False), **_inputs(cfg, FAM_B)}
    S_max = FAM_S + FAM_GEN + 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
    params = model.init(torch.Generator().manual_seed(SEED_PARAMS))
    srt = par.RuntimeConfig()
    cache_like = model.init_cache(FAM_B, S_max, "cpu")
    pre, p_sh, _, c_sh = par.shard_prefill(model, mesh, srt, S_max, params, prompt, cache_like)
    dec, _, _, _ = par.shard_decode_step(model, mesh, srt, params, cache_like,
                                         {"token": prompt["tokens"][:, 0]})
    dparams = par.distribute_tree(mesh, params, p_sh)
    ref_logits, ref_cache = model.prefill(params, prompt, S_max)
    logits, cache = pre(dparams, prompt)
    storage = cache_storage(cache)
    errs, tokens_equal = [_rel(logits, ref_logits)], []
    for _ in range(FAM_GEN):
        tok = ref_logits.argmax(-1)
        tokens_equal.append(bool((_full(logits).argmax(-1) == tok).all()))
        ref_logits, ref_cache = model.decode_step(params, ref_cache, {"token": tok})
        logits, cache = dec(dparams, cache, {"token": tok})
        errs.append(_rel(logits, ref_logits))
    tokens_equal.append(bool((_full(logits).argmax(-1) == ref_logits.argmax(-1)).all()))
    from torch.distributed.tensor import Shard
    from torch.utils._pytree import tree_leaves
    built = par.shard_cache(mesh, cache_like, par.cache_fill(model))
    out["serve"] = {"errs": errs, "tokens_equal": tokens_equal,
                    "sharded_cache_leaves": sum(any(isinstance(p, Shard) for p in t.placements)
                                                for t in tree_leaves(cache)
                                                if hasattr(t, "placements")),
                    "cache_storage": storage,
                    "built_as_init_cache": all(
                        torch.equal(_full(a), b) for a, b in
                        zip(tree_leaves(built), tree_leaves(model.init_cache(FAM_B, S_max, "cpu")),
                            strict=True))}
    return out


def cache_storage(cache) -> list:
    """(path, bytes of the local shard's storage, global bytes, number of
    shards) of each cache leaf that some mesh dim shards."""
    from torch.distributed.tensor import Shard

    from repro_torch.runtime.sharding import map_with_path
    out = []

    def one(path, t):
        n = math.prod(t.device_mesh.size(d) for d, p in enumerate(t.placements)
                      if isinstance(p, Shard))
        if n > 1:
            out.append((path, t.to_local().untyped_storage().nbytes(),
                        t.numel() * t.element_size(), n))
    map_with_path(one, cache)
    return out


def _families_world(rank: int) -> dict:
    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh(2, 2, "cpu")
    out = {}
    for case in CASES:
        t0 = time.perf_counter()
        try:
            out[case] = _family(case, mesh)
        except Exception:
            out[case] = {"error": traceback.format_exc()}
        out[case]["seconds"] = time.perf_counter() - t0
    return out


WORLDS = {"train": (8, _train_world), "serve": (8, _serve_world), "moe": (4, _moe_world),
          "families": (4, _families_world)}


def _worker(world: str, rank: int, n: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = WORLDS[world][1](rank)
    except Exception:
        res = {"error": traceback.format_exc()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_world(world: str, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Spawn the world's ranks (a ``file://`` store under ``tmp``), wait at
    most ``timeout`` seconds, and return each rank's results; a rank that
    raised gives {"error": traceback}."""
    n = WORLDS[world][0]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(world, r, n, str(tmp / "store"), str(tmp)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"world {world!r}: {len(hung)} of {n} ranks still running "
                           f"after {timeout} s")
    results = []
    for r in range(n):
        path = tmp / f"rank{r}.pt"
        if not path.exists():
            results.append({"error": f"rank {r} exited with {procs[r].exitcode} and no results"})
        else:
            results.append(torch.load(path, weights_only=False))
    return results
