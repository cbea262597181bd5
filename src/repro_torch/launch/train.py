"""Training driver: storage provisioning + data staging + the train loop +
burst checkpointing drained to the global FS, on the card.

The port of ``src/repro/launch/train.py``, same flow (the paper's workflow
as a training job):
  1. request compute + storage allocations (scheduler);
  2. provision the EphemeralFS on the granted storage nodes;
  3. stage the corpus in from the global FS and read batches from there;
  4. train, with checkpoints to the burst tier drained to the global FS;
  5. on restart (``--resume``), restore the newest committed checkpoint;
and the held-batch loss before and after. On the card every norm and
attention layer runs its forward and backward kernels (``kernels.ops``).

Run:  PYTHONPATH=src python -m repro_torch.launch.train   (granite-moe-1b-a400m)
      PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b
      PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-12b
      PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b
      PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b
      PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny
      (add ``--device cpu`` to run the plain path on the CPU)
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..configs.base import ModelConfig
from ..core import (
    GlobalFS,
    JobRequest,
    Provisioner,
    Scheduler,
    StorageRequest,
    dom_cluster,
)
from ..data import DatasetSpec, Loader, stage_in, write_corpus
from ..device import resolve_device
from ..models import build_model
from ..models.layers import dtype_of
from ..optim import AdamWConfig
from ..optim.adamw import leaves
from ..runtime import RuntimeConfig, TrainState, make_train_state, make_train_step
from .serve import make_frames


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def to_device(batch: dict, cfg: ModelConfig, device: torch.device) -> dict:
    """A Loader batch (numpy int32) -> int64 token tensors on ``device``. A
    VLM's batch also takes its prefix and the encoder-decoder's its frames,
    as repro's driver feeds them: zero patch embeddings (B, n_patches,
    d_model), zero frame embeddings (B, encoder_seq, d_model), in the dtype
    the model takes them in on the serve path."""
    out = {k: torch.from_numpy(v).to(device=device, dtype=torch.long) for k, v in batch.items()}
    B = out["tokens"].shape[0]
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                          dtype=dtype_of(cfg), device=device)
    if cfg.family == "audio":
        out["frames"] = make_frames(cfg, B, device)
    return out


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 4, seq: int = 128,
          lr: float = 1e-3, ckpt_every: int = 10, seed: int = 0, device: str = "cuda",
          resume: bool = False, storage_nodes: int = 2, log=print) -> dict:
    """Provision, stage the corpus, take ``steps`` steps of ``cfg`` with random
    weights from ``seed``, checkpointing every ``ckpt_every`` steps."""
    dev = resolve_device(device)
    model = build_model(cfg)
    # repro's driver asks for remat "dots", which the port takes as "full"
    rt = RuntimeConfig(remat="full", opt=AdamWConfig(lr=lr), schedule="warmup_cosine")

    # -- storage provisioning (the paper's §III flow) -----------------------
    cluster = dom_cluster()
    sched = Scheduler(cluster)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(seed), rt)
    ckpt_bytes = tree_bytes(state.params) + tree_bytes(state.opt.master) * 3
    alloc = sched.submit(JobRequest("train-lm", n_compute=8,
                                    storage=StorageRequest(nodes=storage_nodes)))
    prov = Provisioner(cluster)
    dep = prov.deploy(prov.plan_for(alloc))
    log(f"[provision] {len(alloc.storage_nodes)} storage nodes, "
        f"modeled deploy {dep.deploy_time_s:.2f}s (ckpt size {ckpt_bytes/1e6:.1f} MB)")
    gfs = GlobalFS()
    try:
        spec = DatasetSpec(seed=7, vocab=cfg.vocab_size,
                           n_tokens=max(1 << 18, batch * (seq + 1) * 4))
        write_corpus(gfs, "/datasets/train", spec)
        rep = stage_in(gfs, dep.fs, "/datasets/train", "/data",
                       src_model=gfs.perf_view(), dst_model=dep.model)
        log(f"[stage-in] {rep.files} files, {rep.bytes/1e6:.1f} MB, "
            f"modeled {rep.modeled_time_s:.2f}s")
        loader = Loader(spec, batch=batch, seq=seq, fs=dep.fs, root="/data")
        mgr = CheckpointManager(dep.fs, global_fs=gfs)

        # -- resume ---------------------------------------------------------
        start_step = 0
        if resume and mgr.steps():
            restored, start_step = mgr.restore({"params": state.params, "opt": state.opt})
            state = TrainState(restored["params"], restored["opt"], state.ef)
            log(f"[resume] restored committed step {start_step}")

        step_fn = make_train_step(model, rt)

        def eval_loss(params, b) -> float:
            with torch.no_grad():
                return float(model.loss(params, b)[0])

        eval_batch = to_device(loader.batch_at(0), cfg, dev)
        eval_before = eval_loss(state.params, eval_batch)

        losses, drains = [], []
        t0 = time.perf_counter()
        for step in range(start_step, steps):
            state, metrics = step_fn(state, to_device(loader.batch_at(step), cfg, dev))
            loss = float(metrics["loss"])
            losses.append(loss)
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                man = mgr.save(step + 1, {"params": state.params, "opt": state.opt})
                drain = mgr.drain_to_global(step + 1)
                drains.append(drain)
                log(f"[ckpt] step {step+1}: {man['total_bytes']/1e6:.1f} MB to burst; "
                    f"drain modeled {drain['modeled_time_s']:.3f}s")
            if step % 5 == 0 or step + 1 == steps:
                log(f"step {step:4d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f}")
        wall = time.perf_counter() - t0
        eval_after = eval_loss(state.params, eval_batch)
        log(f"[done] {steps - start_step} steps in {wall:.1f}s; "
            f"held-batch loss {eval_before:.4f} -> {eval_after:.4f} ({dev.type})")
        result = {
            "losses": losses,
            "eval_before": eval_before,
            "eval_after": eval_after,
            "steps": mgr.steps(),
            "drains": drains,
            "stage_bytes": rep.bytes,
            "deploy_time_s": dep.deploy_time_s,
            "wall_s": wall,
            "improved": eval_after < eval_before,
        }
    finally:
        dep.teardown()
        sched.release(alloc)
        gfs.teardown()
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Train on the card through the provisioned burst tier. The default "
                    "--arch is repro's, granite-moe-1b-a400m (MoE); qwen3-moe-30b-a3b "
                    "(MoE), phi4-mini-3.8b, qwen3-14b and qwen2.5-32b (dense), gemma3-12b "
                    "(local/global attention, head dim 256), zamba2-7b (Mamba2 hybrid), "
                    "xlstm-1.3b (xLSTM) and whisper-tiny (encoder-decoder) also train.")
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--storage-nodes", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 ckpt_every=args.ckpt_every, seed=args.seed, device=args.device,
                 resume=args.resume, storage_nodes=args.storage_nodes)


if __name__ == "__main__":
    main()
