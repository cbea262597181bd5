"""Serving driver: model weights staged through dynamically provisioned
storage, then batched prefill + greedy decode on the card.

The port of ``src/repro/launch/serve.py``, same flow: weights are published
to the global FS (the model registry), a burst tier is scheduled and
provisioned, the weights are staged into it once and every replica loads
from there (modeled time reported), then requests are decoded with a KV
cache. Prefill and decode run the port's kernels on the card.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --requests 8
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
    Workload,
    dom_cluster,
    predict_read,
)
from ..core.staging import stage_tree
from ..device import resolve_device
from ..models import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, prompts: torch.Tensor, gen: int) -> dict:
    """Batched prefill of ``prompts`` (B, P), then ``gen - 1`` greedy decode
    steps. Returns the tokens (B, gen) and the host-clock times, each ending
    in a device synchronise."""
    B, P = prompts.shape
    device = prompts.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts}, P + gen)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    _sync(device)
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, {"token": tok})
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(out, dim=1), "last_logits": logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def serve(cfg: ModelConfig, *, requests: int = 8, prompt_len: int = 48, gen: int = 16,
          seed: int = 0, device: str = "cuda", log=print) -> dict:
    """Publish, stage and serve ``cfg`` with random weights from ``seed``."""
    dev = resolve_device(device)
    model = build_model(cfg)

    # -- publish weights to the global FS (the model registry) --------------
    gfs = GlobalFS()
    try:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        pub = CheckpointManager(gfs, root="/registry/models")
        man = pub.save(0, {"params": params})
        log(f"[registry] published {man['total_bytes']/1e6:.1f} MB to global FS")
        reg = "/registry/models/step-00000000"
        published = sum(gfs.stat(f"{reg}/{n}").size for n in gfs.readdir(reg))

        # -- provision burst tier, stage weights in, load from burst --------
        cluster = dom_cluster()
        sched = Scheduler(cluster)
        alloc = sched.submit(JobRequest("serve", 8, storage=StorageRequest(nodes=2)))
        prov = Provisioner(cluster)
        dep = prov.deploy(prov.plan_for(alloc))
        try:
            burst = CheckpointManager(dep.fs, root="/weights")
            # stage: global -> burst (one read of the registry feeds all replicas)
            rep = stage_tree(gfs, dep.fs, reg, "/weights/step-00000000",
                             src_model=gfs.perf_view(), dst_model=dep.model)
            loaded, _ = burst.restore({"params": params})
            # modeled: 256 hosts each reading the weights from the burst tier (FPP)
            w = Workload(n_procs=256, size_per_proc=man["total_bytes"], pattern="fpp")
            t_all = predict_read(w, dep.model).elapsed_s
            log(f"[stage-in] {rep.bytes/1e6:.1f} MB staged "
                f"(modeled {rep.modeled_time_s:.2f}s); 256-replica load from burst "
                f"modeled {t_all:.2f}s")
        finally:
            dep.teardown()
            sched.release(alloc)
        del params
        params = loaded["params"]

        # -- serve ------------------------------------------------------------
        B, P, G = requests, prompt_len, gen
        prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(seed + 1))
        res = generate(model, params, prompts, G)
        log(f"[serve] {B} requests x {G} tokens: prefill {res['prefill_s']:.3f}s, "
            f"decode {res['decode_s']:.3f}s ({dev.type})")
    finally:
        gfs.teardown()
    return {"generated": tuple(res["tokens"].shape), "tokens": res["tokens"],
            "stage_bytes": rep.bytes, "published_bytes": published,
            "manifest_bytes": man["total_bytes"],
            "stage_modeled_s": rep.modeled_time_s, "load_modeled_s": t_all,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    return serve(cfg, requests=args.requests, prompt_len=args.prompt_len, gen=args.gen,
                 seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
