"""Fault tolerance & elasticity for 1000+-node runs.

Pieces that run in this container (and are tested):
  * **Heartbeat tracking + straggler detection** over node progress reports
    (robust z-score over step latencies);
  * **Restart planning**: given surviving node counts, recompute the mesh
    shape (shrink the data axis, keep "model" intact — TP groups must stay
    whole), pick the checkpoint to restore;
  * **Storage-failure handling**: delivered by the chaos engine
    (`repro.chaos`: `NodeFaultModel` failure domains, mirrored-session
    degradation, pool self-healing on `RetryPolicy` backoff); this module
    supplies the heartbeat/straggler/`revive` primitives its repair path
    builds on.

On a real cluster the heartbeats come from per-host agents; here they are
driven by the training driver / tests.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class NodeHealth:
    node_id: str
    last_beat: float
    step_times: list = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    """Tracks per-node liveness over an injectable clock.

    ``clock`` is the monitor's time source for everything — the initial
    ``last_beat`` stamps, beats, and deadness checks — and defaults to
    ``time.monotonic()`` for real-cluster agents. Virtual-clock callers
    (the workflow orchestrator above all) MUST inject their own source
    (``clock=lambda: engine.now``): a monitor built on the wall clock but
    queried with virtual ``now`` values silently marks every node dead
    (monotonic stamps dwarf small virtual times) or never dead (the other
    way around). See :meth:`repro.orchestrator.Orchestrator.heartbeat_monitor`.
    """

    def __init__(
        self,
        nodes: list[str],
        *,
        timeout_s: float = 60.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.timeout = timeout_s
        self._clock = clock if clock is not None else time.monotonic
        self.nodes = {n: NodeHealth(n, last_beat=self._clock()) for n in nodes}

    def beat(self, node_id: str, step_time_s: Optional[float] = None,
             now: Optional[float] = None) -> None:
        h = self.nodes[node_id]
        h.last_beat = now if now is not None else self._clock()
        if step_time_s is not None:
            h.step_times.append(step_time_s)
            del h.step_times[:-50]

    def dead_nodes(self, now: Optional[float] = None) -> list[str]:
        now = now if now is not None else self._clock()
        out = []
        for h in self.nodes.values():
            if h.alive and now - h.last_beat > self.timeout:
                h.alive = False
            if not h.alive:
                out.append(h.node_id)
        return out

    def revive(self, node_id: str, now: Optional[float] = None) -> None:
        """Bring a repaired node back into the fleet (the chaos repair
        path): fresh heartbeat stamp, stale step-time samples dropped — a
        node returning from repair must not inherit its pre-failure
        latencies into straggler detection."""
        h = self.nodes[node_id]
        h.alive = True
        h.last_beat = now if now is not None else self._clock()
        h.step_times.clear()

    def stragglers(self, *, z: float = 3.0, min_samples: int = 5,
                   now: Optional[float] = None) -> list[str]:
        """Nodes whose median step time is a robust outlier vs the fleet.

        Deadness is refreshed first so timed-out nodes are excluded from
        both the fleet median and the candidate set: a node that stopped
        beating but was never observed through :meth:`dead_nodes` must
        neither drag the median nor be reported as merely "slow" when it
        is in fact gone.
        """
        self.dead_nodes(now)
        meds = {
            n: float(np.median(h.step_times))
            for n, h in self.nodes.items()
            if h.alive and len(h.step_times) >= min_samples
        }
        if len(meds) < 3:
            return []
        vals = np.array(list(meds.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [n for n, v in meds.items() if (v - med) / (1.4826 * mad) > z]


@dataclasses.dataclass(frozen=True)
class RestartPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    restore_step: Optional[int]
    dropped_nodes: tuple[str, ...]


def plan_restart(
    *,
    alive_chips: int,
    model_parallel: int,
    committed_steps: list[int],
    dropped_nodes: tuple[str, ...] = (),
    pods: int = 1,
) -> RestartPlan:
    """Shrink the data axis to what the surviving chips support; "model"
    groups are kept whole (a TP group with a dead member is dropped)."""
    if alive_chips < model_parallel:
        raise RuntimeError("fewer chips than one model-parallel group")
    groups = alive_chips // model_parallel
    if pods > 1 and groups % pods == 0:
        shape = (pods, groups // pods, model_parallel)
        axes = ("pod", "data", "model")
    else:
        shape = (groups, model_parallel)
        axes = ("data", "model")
    return RestartPlan(
        mesh_shape=shape,
        mesh_axes=axes,
        restore_step=committed_steps[-1] if committed_steps else None,
        dropped_nodes=dropped_nodes,
    )


# --------------------------------------------------------------------------
# Per-phase fault injection for the workflow orchestrator
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-phase trip probabilities for a provisioning workflow.

    Each probability is the chance that the named lifecycle phase fails on
    a given attempt (deploy daemon crash, staging transfer error, node loss
    mid-run). Deterministic under ``seed`` so campaigns are reproducible.
    """

    provision_fail_p: float = 0.0
    stage_in_fail_p: float = 0.0
    run_fail_p: float = 0.0
    stage_out_fail_p: float = 0.0
    #: per-attempt trip probability for one *task* inside a pilot (the
    #: in-pilot scheduler consults phase "task" once per completed attempt;
    #: plain jobs never draw from it)
    task_fail_p: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        for f in ("provision_fail_p", "stage_in_fail_p", "run_fail_p",
                  "stage_out_fail_p", "task_fail_p"):
            p = getattr(self, f)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {p}")


class FaultInjector:
    """Seeded coin-flipper the orchestrator consults at each phase boundary."""

    _PHASE_FIELDS = {
        "provision": "provision_fail_p",
        "stage_in": "stage_in_fail_p",
        "run": "run_fail_p",
        "stage_out": "stage_out_fail_p",
        "task": "task_fail_p",
    }

    def __init__(self, spec: FaultSpec | None = None):
        self.spec = spec or FaultSpec()
        self._rng = random.Random(self.spec.seed)
        self.trips: list[tuple[str, str]] = []     # (job_name, phase)

    @property
    def any_faults(self) -> bool:
        """Is there any probability mass at all? Campaign engines skip the
        per-phase coin flip for stock fault-free injectors — a zero
        probability never consumes a random draw, so the skip is
        behavior-identical."""
        s = self.spec
        return (
            s.provision_fail_p > 0.0
            or s.stage_in_fail_p > 0.0
            or s.run_fail_p > 0.0
            or s.stage_out_fail_p > 0.0
            or s.task_fail_p > 0.0
        )

    def trip(self, job_name: str, phase: str) -> bool:
        """Does ``phase`` of ``job_name`` fail on this attempt?"""
        try:
            field = self._PHASE_FIELDS[phase]
        except KeyError:
            valid = ", ".join(sorted(self._PHASE_FIELDS))
            raise ValueError(
                f"unknown phase {phase!r}: valid phases are {valid}"
            ) from None
        p = getattr(self.spec, field)
        tripped = p > 0.0 and self._rng.random() < p
        if tripped:
            self.trips.append((job_name, phase))
        return tripped
