"""PilotSpec + PilotRun: the glue between the two scheduler levels.

:class:`PilotSpec` describes the top-level acquisition — a block of compute
nodes, a slot density, and the pooled storage the whole task stream shares.
:class:`PilotRun` is the live bottom-level runtime bound to one orchestrator
job record: it owns the :class:`~repro.pilot.TaskScheduler`, arms exactly one
engine event at a time (the earliest task end), and reports completions to
the orchestrator only when the whole stream drains — so the global engine
sees one RUNNING phase per pilot *attempt*, however many tasks ran inside.

This module deliberately imports nothing from ``repro.orchestrator`` or
``repro.provision`` (the orchestrator constructs PilotRun and injects the
engine/recorder/session, all duck-typed): the pilot layer sits below both
and must stay importable from the hot loop without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

from .scheduler import TaskScheduler, TaskStats
from .task import TaskSpec


@dataclasses.dataclass(frozen=True)
class PilotSpec:
    """The top-level half of a pilot: what the orchestrator acquires once.

    ``n_compute * slots_per_node`` becomes the pilot's slot pool; a task
    with ``cores=1/slots_per_node`` occupies one slot. ``datasets`` and the
    stage bytes describe the *pilot-wide* storage session (POOLED — leases
    keep the datasets warm across the whole task stream); per-task private
    I/O lives on each :class:`TaskSpec`.

    ``completion_quantum_s`` coalesces heterogeneous task ends onto a
    shared grid (fewer, larger batches). ``open_ended=True`` marks a pilot
    that accepts late task submissions: it makes no EASY release promise,
    so backfill never books holes against it.
    """

    name: str
    n_compute: int
    slots_per_node: int = 8
    datasets: Tuple = ()
    stage_in_bytes: float = 0.0
    stage_out_bytes: float = 0.0
    n_streams: int = 8
    #: job-level retries for the pilot itself (task retries live on TaskSpec)
    max_retries: int = 2
    completion_quantum_s: float = 0.0
    open_ended: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "datasets", tuple(self.datasets))
        if not self.name:
            raise ValueError("pilot name must be non-empty")
        if self.n_compute < 1:
            raise ValueError(f"{self.name}: n_compute must be >= 1")
        if self.slots_per_node < 1:
            raise ValueError(f"{self.name}: slots_per_node must be >= 1")
        if self.stage_in_bytes < 0 or self.stage_out_bytes < 0:
            raise ValueError(f"{self.name}: stage bytes must be >= 0")
        if self.max_retries < 0:
            raise ValueError(f"{self.name}: max_retries must be >= 0")
        if self.completion_quantum_s < 0:
            raise ValueError(f"{self.name}: completion_quantum_s must be >= 0")

    @property
    def n_slots(self) -> int:
        return self.n_compute * self.slots_per_node


class PilotRun:
    """One pilot's bottom-level runtime, attached to its JobRecord.

    Lifecycle (all driven by the orchestrator):

    * ``begin(session, now, ...)`` — the job reached RUNNING: bind wave
      pricing to the session, pack the first wave, arm the wake;
    * ``_wake`` — the armed engine event: drain the due completion batch,
      repack, re-arm; when the stream drains, call ``on_complete`` (the
      orchestrator's ``_run_done``) so staging-out/teardown proceed exactly
      like a plain job;
    * ``suspend(now)`` — the attempt lost its grant (job fault, preemption,
      unsurvivable node loss): requeue resident tasks with committed
      progress; a later attempt re-begins with the backlog intact;
    * ``on_node_down/on_node_repair`` — the PR 9 chaos path: the pilot
      *degrades* (slots shrink in proportion to the lost pool backing,
      resident tasks requeue and repack) instead of dying.

    Stale engine events are neutralized by the wake-token pattern the
    orchestrator uses for phases: every suspend/resize bumps ``_wake_token``
    and an old event finds its token mismatched and returns.
    """

    __slots__ = (
        "spec", "engine", "recorder", "counters", "job_id", "tasks",
        "state", "session", "_wake_token", "_wake_at", "_on_complete",
        "_reproject", "_pool_nodes", "_lost_nodes",
    )

    def __init__(
        self,
        spec: PilotSpec,
        *,
        engine,
        recorder,
        counters=None,
        trip: Optional[Callable[[str], bool]] = None,
        job_id: int = 0,
    ) -> None:
        self.spec = spec
        self.engine = engine
        self.recorder = recorder
        #: orchestrator LiveCounters (duck-typed; None for standalone use)
        self.counters = counters
        self.job_id = job_id
        self.tasks = TaskScheduler(
            slots=spec.n_slots,
            slots_per_node=spec.slots_per_node,
            quantum_s=spec.completion_quantum_s,
            trip=trip,
        )
        self.state = "idle"                 # idle -> running -> drained
        self.session = None
        self._wake_token = 0
        self._wake_at: Optional[float] = None
        self._on_complete: Optional[Callable[[], None]] = None
        self._reproject: Optional[Callable[[], None]] = None
        self._pool_nodes = 0
        self._lost_nodes: set = set()

    @property
    def stats(self) -> TaskStats:
        return self.tasks.stats

    # -- task submission ---------------------------------------------------
    def submit(self, task: TaskSpec, n: int = 1) -> None:
        """Queue ``n`` instances; packs immediately if the pilot is live
        (late submission — see ``PilotSpec.open_ended``)."""
        self.tasks.submit(task, n)
        c = self.counters
        if c is not None:
            c.tasks_submitted += n
        if self.state == "running":
            self.tasks.pack(self.engine.now)
            self._arm()
            if self._reproject is not None:
                self._reproject()

    def submit_many(self, tasks: Iterable[TaskSpec]) -> None:
        for t in tasks:
            self.submit(t)

    # -- attempt lifecycle -------------------------------------------------
    def begin(
        self,
        session,
        now: float,
        *,
        on_complete: Callable[[], None],
        reproject: Optional[Callable[[], None]] = None,
        pool_nodes: int = 0,
    ) -> None:
        """The pilot job reached RUNNING on a fresh session/lease: bind the
        wave pricing, forget any previous attempt's node losses (the new
        lease's pool is priced degraded by the session itself if it is
        still hurt), pack the first wave, and arm the wake."""
        ts = self.tasks
        self.session = session
        self._on_complete = on_complete
        self._reproject = reproject
        self._pool_nodes = int(pool_nodes)
        self._lost_nodes.clear()
        ts.set_lost_slots(0)
        ts.price_in = lambda b: session.stage_time_s(b, "in")
        ts.price_out = lambda b: session.stage_time_s(b, "out")
        self.state = "running"
        packed = ts.pack(now)
        rec = self.recorder
        if rec.enabled:
            rec.pilot_started(
                self.spec.name, self.job_id, now,
                n_tasks=ts.n_queued + ts.n_running,
                n_slots=ts.effective_slots,
                packed=packed,
            )
        if ts.drained:
            # an empty pilot (or one whose backlog already failed out)
            # completes its RUNNING phase immediately
            self._finish()
            return
        self._arm()

    def suspend(self, now: float) -> None:
        """The attempt released its grant (job-level fault/preemption or an
        unsurvivable node loss). Resident tasks requeue with committed
        progress; the engine event, if armed, is invalidated."""
        if self.state != "running":
            return
        self._wake_token += 1
        self._wake_at = None
        self.state = "idle"
        self.session = None
        self.tasks.interrupt(now)

    def projected_run_s(self, session=None) -> float:
        """Remaining-drain estimate for EASY projections; prices the
        backlog's wave I/O through ``session`` when the pilot is not yet
        bound to one (admission-time projection)."""
        ts = self.tasks
        run = ts.pending_run_s / ts.effective_slots
        s = session if session is not None else self.session
        if s is not None:
            if ts.pending_in_bytes > 0.0:
                run += s.stage_time_s(ts.pending_in_bytes, "in")
            if ts.pending_out_bytes > 0.0:
                run += s.stage_time_s(ts.pending_out_bytes, "out")
        return run

    # -- chaos (PR 9 path) -------------------------------------------------
    def on_node_down(self, node_id: str, now: float) -> None:
        """A storage node backing the pilot's pool died: shrink the slot
        pool in proportion to the lost backing (the session's bandwidth
        shrank with it), requeue resident tasks, repack, re-arm."""
        if node_id in self._lost_nodes:
            return
        self._lost_nodes.add(node_id)
        if self.state != "running":
            return
        self._wake_token += 1
        self._wake_at = None
        ts = self.tasks
        ts.interrupt(now)
        self._apply_slot_loss()
        packed = ts.pack(now)
        rec = self.recorder
        if rec.enabled:
            rec.pilot_resized(
                self.spec.name, self.job_id, now,
                n_slots=ts.effective_slots, cause=node_id, packed=packed,
            )
        if self._reproject is not None:
            self._reproject()
        self._arm()

    def on_node_repair(self, node_id: str, now: float) -> None:
        """A lost backing node came back (pool self-healed): restore slots
        and pack the widened pool."""
        if node_id not in self._lost_nodes:
            return
        self._lost_nodes.discard(node_id)
        if self.state != "running":
            return
        ts = self.tasks
        self._apply_slot_loss()
        packed = ts.pack(now)
        rec = self.recorder
        if rec.enabled:
            rec.pilot_resized(
                self.spec.name, self.job_id, now,
                n_slots=ts.effective_slots, cause="repair", packed=packed,
            )
        if self._reproject is not None:
            self._reproject()
        self._arm()

    def _apply_slot_loss(self) -> None:
        ts = self.tasks
        if not self._lost_nodes or self._pool_nodes <= 0:
            ts.set_lost_slots(0)
            return
        frac = min(1.0, len(self._lost_nodes) / self._pool_nodes)
        ts.set_lost_slots(int(round(ts.base_slots * frac)))

    # -- engine wake plumbing ----------------------------------------------
    def _arm(self) -> None:
        """Keep exactly one valid engine event: the earliest task end. If
        an armed wake already fires at or before the new heap minimum it is
        kept (it will re-arm); otherwise the token bump strands it."""
        if self.state != "running":
            return
        nxt = self.tasks.next_wake()
        if nxt is None:
            return
        if self._wake_at is not None and self._wake_at <= nxt:
            return
        self._wake_token += 1
        token = self._wake_token
        self._wake_at = nxt
        self.engine.at(nxt, lambda: self._wake(token))

    def _wake(self, token: int) -> None:
        if token != self._wake_token:
            return
        self._wake_at = None
        ts = self.tasks
        now = self.engine.now
        completed, failed, requeued = ts.advance(now)
        packed = ts.pack(now)
        c = self.counters
        if c is not None:
            c.tasks_done += completed
            c.tasks_failed += failed
            c.task_retries += requeued
        rec = self.recorder
        if rec.enabled:
            rec.task_batch(
                self.spec.name, self.job_id, now,
                completed=completed, failed=failed, requeued=requeued,
                packed=packed, queued=ts.n_queued, running=ts.n_running,
                occupancy=ts.occupancy,
            )
        if ts.drained:
            self._finish()
            return
        self._arm()

    def _finish(self) -> None:
        self.state = "drained"
        self._wake_token += 1
        self._wake_at = None
        cb = self._on_complete
        self._on_complete = None
        if cb is not None:
            cb()
