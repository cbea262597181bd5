"""Elastic restart: a training job on mirrored job-scoped storage loses a
storage node, plans a smaller mesh, restores its checkpoint through the
surviving mirror and resumes.

The port of ``examples/elastic_restart.py`` as a function, same flow:
  1. open a mirrored two-node ``ephemeralfs`` session (``provision``) on the
     Dom cluster for 8 compute nodes, materialized;
  2. train ``steps`` steps on a fixed all-ones batch (``launch.train.to_device``
     adds the VLM's prefix and the encoder-decoder's zero frames), every
     compute node beating its heartbeat (node 3 reports 4x the step time),
     saving ``{"params", "opt"}`` to the session's file system every
     ``ckpt_every`` steps;
  3. kill the second storage node; the file system is degraded;
  4. ``plan_restart`` for 240 surviving chips in model groups of 16;
  5. restore the newest committed step through the degraded mirror, check
     every leaf against the live state, and take one more step from it and
     from a clone of the live state, on the same batch;
  6. release the session.

``examples/torch_elastic_restart.py`` is its command line.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..checkpoint import CheckpointManager
from ..configs.base import ModelConfig
from ..core import dom_cluster
from ..device import resolve_device
from ..models import build_model
from ..optim import AdamWConfig
from ..provision import Placement, ProvisioningService, StorageSpec
from ..runtime import (
    HeartbeatMonitor,
    RuntimeConfig,
    TrainState,
    make_train_state,
    make_train_step,
    plan_restart,
)
from .train import to_device

STRAGGLER = 3          # the compute node that reports a 4x step time


def _mismatches(got, want) -> int:
    """Leaves of ``got`` that differ from ``want``'s in dtype, device or any
    bit."""
    return sum(not (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y))
               for x, y in zip(pytree.tree_leaves(got), pytree.tree_leaves(want), strict=True))


def elastic_restart(cfg: ModelConfig, *, device: str = "cuda", steps: int = 6,
                    ckpt_every: int = 3, batch: int = 4, seq: int = 64, lr: float = 1e-3,
                    remat: str | None = None, state: TrainState | None = None, seed: int = 0,
                    log=print) -> dict:
    """The flow of the module docstring on ``cfg``. ``state`` is a starting
    train state on ``device``; without it, ``make_train_state`` runs on a
    generator seeded with ``seed``. ``steps`` is a multiple of
    ``ckpt_every``, so that the newest save is the live state."""
    if steps < ckpt_every or steps % ckpt_every:
        raise ValueError(f"steps ({steps}) must be a multiple of ckpt_every ({ckpt_every})")
    dev = resolve_device(device)
    svc = ProvisioningService(dom_cluster())
    session = svc.open_session(
        StorageSpec("elastic", nodes=2, managers=("ephemeralfs",),
                    placement=Placement(mirror=True)),
        n_compute=8, materialize=True)
    try:
        alloc, dep = session.allocation, session.deployment
        mgr = CheckpointManager(dep.fs)
        model = build_model(cfg)
        rt = RuntimeConfig(remat=remat, zero1=False, opt=AdamWConfig(lr=lr))
        if state is None:
            state = make_train_state(model, torch.Generator(device=dev).manual_seed(seed), rt)
        step_fn = make_train_step(model, rt)
        ones = np.ones((batch, seq), np.int32)
        data = to_device({"tokens": ones, "labels": ones}, cfg, dev)

        # -- train with heartbeats and checkpoints ---------------------------
        mon = HeartbeatMonitor([n.node_id for n in alloc.compute_nodes], timeout_s=60)
        losses, step_ms, save_s, ckpt_bytes = [], [], [], 0
        for step in range(steps):
            t0 = time.perf_counter()
            state, m = step_fn(state, data)
            losses.append(float(m["loss"]))          # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for i, n in enumerate(alloc.compute_nodes):
                mon.beat(n.node_id, step_time_s=4.0 if i == STRAGGLER else 1.0)
            if (step + 1) % ckpt_every == 0:
                t0 = time.perf_counter()
                ckpt_bytes = mgr.save(step + 1, {"params": state.params,
                                                 "opt": state.opt})["total_bytes"]
                save_s.append(time.perf_counter() - t0)
        stragglers = mon.stragglers()
        log(f"straggler detection: {stragglers}")

        # -- a storage node dies -----------------------------------------------
        victim = session.storage_nodes[1].node_id
        dep.fs.kill_node(victim)
        degraded = dep.fs.degraded()
        log(f"killed {victim}; FS degraded={degraded} (mirrored chunks keep serving)")

        plan = plan_restart(alive_chips=240, model_parallel=16, committed_steps=mgr.steps(),
                            dropped_nodes=(victim,))
        log(f"restart plan: mesh {plan.mesh_shape} axes {plan.mesh_axes}, "
            f"restore step {plan.restore_step}")

        # -- restore through the degraded mirror, resume -------------------------
        live = {"params": state.params, "opt": state.opt}
        t0 = time.perf_counter()
        restored, rstep = mgr.restore(live)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mismatches = _mismatches(restored, live)
        _, m = step_fn(pytree.tree_map(torch.clone, state), data)
        live_loss = float(m["loss"])
        _, m = step_fn(TrainState(restored["params"], restored["opt"], ()), data)
        resumed = float(m["loss"])
        log(f"resumed from step {rstep}; next loss {resumed:.4f}")
        return {
            "stragglers": stragglers, "victim": victim, "degraded": degraded,
            "plan": {"mesh_shape": plan.mesh_shape, "mesh_axes": plan.mesh_axes,
                     "restore_step": plan.restore_step},
            "committed": mgr.steps(), "restored_step": rstep,
            "losses": losses, "resumed_loss": resumed, "live_loss": live_loss,
            "step_ms": step_ms, "restored_mismatches": mismatches,
            "ckpt_bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
            "modeled_write_s": session.checkpoint_write_s(ckpt_bytes),
            "modeled_stage_out_s": session.stage_time_s(ckpt_bytes, "out"),
        }
    finally:
        session.release()

