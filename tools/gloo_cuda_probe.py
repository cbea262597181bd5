#!/usr/bin/env python3
"""Whether gloo takes CUDA tensors for each collective the port's mesh path
uses (DTensor's redistributions, the decode merge, ``int8_allreduce``),
with two ranks on one card (``cuda:0``), where NCCL refuses two ranks on
one GPU.

Each collective runs in a fresh pair of processes, so that one that crashes
a process takes only its own answer with it. Prints one JSON line:
{collective: "ok", the exact error, or how the ranks ended}. Exits 0 either
way; the answer decides whether ``chip_smoke.py``'s two-rank phase can run.

    python3 tools/gloo_cuda_probe.py
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _probe(rank: int, port: int, out: str, only: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {}

    def attempt(name, fn):
        if name != only:
            return
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:           # the exact error is the result
            res[name] = f"{type(e).__name__}: {e}".splitlines()[0][:400]

    x = torch.full((8, 4), float(rank + 1), device=dev)
    attempt("all_reduce", lambda: dist.all_reduce(x.clone()))
    attempt("all_gather_into_tensor",
            lambda: dist.all_gather_into_tensor(torch.empty(16, 4, device=dev), x))
    attempt("reduce_scatter_tensor",
            lambda: dist.reduce_scatter_tensor(torch.empty(4, 4, device=dev), x))
    attempt("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x), x))
    attempt("all_to_all_single int8",
            lambda: dist.all_to_all_single(torch.empty(8, 4, dtype=torch.int8, device=dev),
                                           x.to(torch.int8)))
    attempt("broadcast", lambda: dist.broadcast(x.clone(), 0))

    def mesh():
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh("cuda", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))

    def funcol_all_gather():
        from torch.distributed import _functional_collectives as funcol
        funcol.all_gather_tensor(x, 0, dist.group.WORLD).wait()

    def distribute(place):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        m = mesh()
        return m, distribute_tensor(torch.arange(32.0, device=dev).reshape(8, 4), m,
                                    [Replicate(), Shard(0)], src_data_rank=None)

    def full_tensor():
        _, t = distribute(None)
        assert torch.equal(t.full_tensor(), torch.arange(32.0, device=dev).reshape(8, 4))

    def shard_to_shard():
        from torch.distributed.tensor import Replicate, Shard
        m, t = distribute(None)
        t.redistribute(m, [Replicate(), Shard(1)]).to_local()

    attempt("funcol all_gather_tensor", funcol_all_gather)
    attempt("device mesh", mesh)
    attempt("distribute_tensor", lambda: distribute(None))
    attempt("dtensor full_tensor", full_tensor)
    attempt("dtensor Shard(0) -> Shard(1)", shard_to_shard)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
         "all_to_all_single int8", "broadcast", "funcol all_gather_tensor", "device mesh",
         "distribute_tensor", "dtensor full_tensor", "dtensor Shard(0) -> Shard(1)")


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in NAMES:
            out = os.path.join(tmp, f"{len(res)}.json")
            try:
                mp.spawn(_probe, args=(_free_port(), out, name), nprocs=2, join=True)
                with open(out) as f:
                    res.update(json.load(f))
            except Exception:
                res[name] = traceback.format_exc().strip().splitlines()[-1]
    print(json.dumps({"phase": "gloo_cuda_probe", **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
