"""Seeded node fault model: when storage nodes die and come back.

The model is *generated up front*: :meth:`NodeFaultModel.events` returns a
finite, sorted event list over an explicit horizon, which the orchestrator
bulk-schedules with ``engine.at_many``. Two properties follow directly:

* determinism — the same ``(seed, node set, horizon, schedule)`` always
  yields the same events, byte for byte, independent of campaign load
  (per-node streams are seeded ``random.Random(f"{seed}:{node_id}")``, so
  adding a node never perturbs another node's draws);
* termination — the engine heap always drains: there is no
  self-rescheduling failure loop, just a bounded batch of events.

Failures per node are an alternating renewal process: time-to-failure is
exponential with mean ``mttf_s`` (the memoryless hardware-failure model),
repair follows ``mttr_s`` later, and the next draw starts after the
repair. Scripted kills — the reproducible "pull *this* node at *this*
time" experiments the benchmarks and examples run — merge into the same
stream and get the same repair-after-MTTR treatment. Overlapping windows
(a scripted kill landing inside a drawn outage) are legal; the consumer's
down/repair handlers are idempotent, so a duplicate "down" is a no-op and
the earliest "up" at-or-after both ends the outage.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """One scheduled state change for one storage node."""

    t: float
    node_id: str
    kind: str                    # "down" | "up"

    def __post_init__(self) -> None:
        if self.kind not in ("down", "up"):
            raise ValueError(f"kind must be 'down' or 'up', got {self.kind!r}")
        if self.t < 0:
            raise ValueError(f"event time must be >= 0, got {self.t}")


class NodeFaultModel:
    """Deterministic storage-node failure/repair schedule.

    Parameters
    ----------
    node_ids:
        The storage nodes in the fault domain (typically every storage
        node id of the cluster). Order does not matter — draws are keyed
        by id, not position.
    mttf_s:
        Mean time to failure for the exponential draws; ``None`` disables
        random failures (scripted kills only).
    mttr_s:
        Repair time: every failure (drawn or scripted) is followed by an
        "up" event ``mttr_s`` later.
    horizon_s:
        Failures are only generated strictly before this time (repairs
        may land after it). Bounds the event batch; with ``mttf_s`` set
        this must be positive.
    seed:
        Base seed; per-node streams derive from ``f"{seed}:{node_id}"``.
    schedule:
        Scripted ``(t, node_id)`` kills merged into the stream.
    """

    def __init__(
        self,
        node_ids: Iterable[str],
        *,
        mttf_s: Optional[float] = None,
        mttr_s: float = 600.0,
        horizon_s: float = 0.0,
        seed: int = 0,
        schedule: Sequence[tuple[float, str]] = (),
    ):
        self.node_ids = tuple(node_ids)
        if mttf_s is not None and mttf_s <= 0:
            raise ValueError(f"mttf_s must be positive, got {mttf_s}")
        if mttr_s <= 0:
            raise ValueError(f"mttr_s must be positive, got {mttr_s}")
        if mttf_s is not None and horizon_s <= 0:
            raise ValueError("random failures (mttf_s) need a positive horizon_s")
        known = set(self.node_ids)
        for t, nid in schedule:
            if nid not in known:
                raise ValueError(f"scripted kill for unknown node {nid!r}")
            if t < 0:
                raise ValueError(f"scripted kill at negative time {t}")
        self.mttf_s = mttf_s
        self.mttr_s = mttr_s
        self.horizon_s = horizon_s
        self.seed = seed
        self.schedule = tuple(schedule)

    @property
    def any_faults(self) -> bool:
        """False iff this model can never emit an event — the orchestrator
        treats such a model exactly like no model at all (chaos off)."""
        return bool(self.schedule) or self.mttf_s is not None

    def events(self) -> list[NodeEvent]:
        """The full failure/repair schedule, sorted by ``(t, node_id)``
        with repairs before failures at equal instants (a node swapping
        down->up at one instant frees before the next kill lands)."""
        out: list[NodeEvent] = []
        mttf, mttr = self.mttf_s, self.mttr_s
        if mttf is not None:
            for nid in sorted(self.node_ids):
                rng = random.Random(f"{self.seed}:{nid}")
                t = rng.expovariate(1.0 / mttf)
                while t < self.horizon_s:
                    out.append(NodeEvent(t, nid, "down"))
                    t += mttr
                    out.append(NodeEvent(t, nid, "up"))
                    t += rng.expovariate(1.0 / mttf)
        for t, nid in self.schedule:
            out.append(NodeEvent(t, nid, "down"))
            out.append(NodeEvent(t + mttr, nid, "up"))
        out.sort(key=lambda e: (e.t, e.node_id, 0 if e.kind == "up" else 1))
        return out
