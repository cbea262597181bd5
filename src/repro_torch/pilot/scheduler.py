"""In-pilot task scheduler: wave packing, batch pricing, coalesced ends.

This is the bottom level of the two-level scheduler. The top level (the
orchestrator) pays one full job lifecycle — one negotiation, one pooled
session, one block grant — per *pilot*; this class then runs thousands to
millions of tasks inside that grant for O(1) amortized engine events per
completion *batch* instead of 7+ per task. Three mechanisms make that true:

* **wave packing** — :meth:`pack` starts every queued task that fits the
  free slots in one pass (FIFO with head-blocking, like the global
  scheduler's queue discipline: a task that does not fit blocks the tail,
  so identical-shape streams never starve large tasks);
* **batch pricing** — a wave's stage-in/out bytes are summed and priced
  through the session's performance model ONCE per wave
  (:attr:`price_in`/:attr:`price_out`), not once per task: the session
  memoizes per byte-count, and a wave of 10k identical tasks costs one
  model walk;
* **coalesced completions** — task ends live in a local heap, not the
  engine heap. The pilot arms a single engine event at the earliest end;
  :meth:`advance` then drains *every* end due at that instant in one call.
  ``quantum_s`` optionally rounds ends up to a shared grid so even
  heterogeneous waves complete in batches.

Task-level fault handling stays inside the pilot: a tripped task requeues
with its checkpoint-committed progress (or fails after ``max_retries``)
without the global scheduler ever seeing an event. :meth:`interrupt`
supports the pilot-level fault path — job preemption or node loss requeues
every resident task, keeping progress in ``checkpoint_every_s`` multiples.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Callable, List, Optional, Tuple

from .task import T_DONE, T_FAILED, T_PENDING, T_RUNNING, TaskRecord, TaskSpec

_EPS = 1e-9


def _zero(_nbytes: float) -> float:
    return 0.0


@dataclasses.dataclass(slots=True)
class TaskStats:
    """Lifetime counters for one pilot's task stream."""

    submitted: int = 0
    done: int = 0
    failed: int = 0
    #: fault requeues (count against each task's ``max_retries``)
    retries: int = 0
    #: tasks re-packed with committed progress after a fault/interruption
    resumes: int = 0
    #: interruption sweeps (pilot preempted / node lost)
    interrupts: int = 0
    #: pack passes that started at least one task
    waves: int = 0
    #: run seconds NOT re-executed thanks to task-level checkpoints
    run_s_saved: float = 0.0

    @property
    def terminal(self) -> int:
        return self.done + self.failed


class TaskScheduler:
    """Packs :class:`TaskSpec` s into a pilot's slot pool (see module doc).

    The pilot owns ``slots = n_compute * slots_per_node`` slots; a task
    occupies ``ceil(cores * slots_per_node)`` of them. ``set_lost_slots``
    models degraded backing (chaos node loss): the effective pool shrinks
    but never below one slot, so a degraded pilot drains slowly rather
    than deadlocking.
    """

    __slots__ = (
        "base_slots", "slots_per_node", "lost_slots", "busy_slots",
        "quantum_s", "trip", "price_in", "price_out", "stats",
        "pending_run_s", "pending_in_bytes", "pending_out_bytes",
        "_queue", "_ends", "_seq", "_ids",
    )

    def __init__(
        self,
        *,
        slots: int,
        slots_per_node: int = 1,
        quantum_s: float = 0.0,
        trip: Optional[Callable[[str], bool]] = None,
    ) -> None:
        if slots <= 0:
            raise ValueError("a pilot needs at least one task slot")
        if quantum_s < 0:
            raise ValueError("quantum_s must be >= 0")
        self.base_slots = int(slots)
        self.slots_per_node = max(1, int(slots_per_node))
        self.lost_slots = 0
        self.busy_slots = 0
        self.quantum_s = float(quantum_s)
        #: fault oracle ``trip(task_name) -> bool``, consulted once per
        #: completed attempt; ``None`` disables task faults entirely (the
        #: hot path skips the call, not just the outcome)
        self.trip = trip
        #: wave I/O pricing, bound to the pilot's session at begin();
        #: each takes aggregate bytes and returns modeled seconds
        self.price_in: Callable[[float], float] = _zero
        self.price_out: Callable[[float], float] = _zero
        self.stats = TaskStats()
        #: advisory projection aggregates over non-terminal tasks (used for
        #: the pilot's EASY release projection; committed progress is
        #: ignored, so these are slight over-estimates after resumes)
        self.pending_run_s = 0.0
        self.pending_in_bytes = 0.0
        self.pending_out_bytes = 0.0
        self._queue: deque = deque()
        #: running tasks as a local min-heap of (end_t, seq, record,
        #: run_start); every running task has exactly one entry (interrupt
        #: clears the whole heap), so no lazy deletion is needed
        self._ends: List[Tuple[float, int, TaskRecord, float]] = []
        self._seq = itertools.count()
        self._ids = itertools.count(1)

    # -- capacity ----------------------------------------------------------
    @property
    def effective_slots(self) -> int:
        return max(1, self.base_slots - self.lost_slots)

    @property
    def free_slots(self) -> int:
        return max(0, self.effective_slots - self.busy_slots)

    @property
    def occupancy(self) -> float:
        return self.busy_slots / self.effective_slots

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_running(self) -> int:
        return len(self._ends)

    @property
    def drained(self) -> bool:
        return not self._queue and not self._ends

    def set_lost_slots(self, n: int) -> None:
        self.lost_slots = max(0, min(int(n), self.base_slots))

    def slots_for(self, spec: TaskSpec) -> int:
        return max(1, math.ceil(spec.cores * self.slots_per_node - _EPS))

    # -- submission --------------------------------------------------------
    def submit(self, spec: TaskSpec, n: int = 1) -> int:
        """Queue ``n`` instances of ``spec``; returns ``n``. O(1) per task
        — records share the spec, aggregates update once per call."""
        if n <= 0:
            return 0
        need = self.slots_for(spec)
        if need > self.base_slots:
            raise ValueError(
                f"task {spec.name!r} needs {need} slots but the pilot has "
                f"only {self.base_slots}"
            )
        q = self._queue
        ids = self._ids
        for _ in range(n):
            q.append(TaskRecord(spec=spec, task_id=next(ids), slots=need))
        self.stats.submitted += n
        self.pending_run_s += spec.run_time_s * n
        self.pending_in_bytes += spec.stage_in_bytes * n
        self.pending_out_bytes += spec.stage_out_bytes * n
        return n

    # -- wave packing ------------------------------------------------------
    def pack(self, now: float) -> int:
        """Start one wave: pop queued tasks (FIFO, head-blocking) while they
        fit the free slots, price the wave's aggregate I/O once, and push
        every end onto the local heap. Returns tasks started."""
        free = self.effective_slots - self.busy_slots
        q = self._queue
        if free <= 0 or not q:
            return 0
        wave = []
        in_b = 0.0
        out_b = 0.0
        while q:
            rec = q[0]
            if rec.slots > free:
                break
            q.popleft()
            free -= rec.slots
            spec = rec.spec
            in_b += spec.stage_in_bytes
            out_b += spec.stage_out_bytes
            wave.append(rec)
        if not wave:
            return 0
        io_s = 0.0
        if in_b > 0.0:
            io_s += self.price_in(in_b)
        if out_b > 0.0:
            io_s += self.price_out(out_b)
        run_start = now + io_s
        q_s = self.quantum_s
        ends = self._ends
        seq = self._seq
        st = self.stats
        busy = 0
        for rec in wave:
            busy += rec.slots
            rec.state = T_RUNNING
            committed = rec.committed_run_s
            if committed > 0.0:
                st.resumes += 1
                st.run_s_saved += committed
            end = run_start + (rec.spec.run_time_s - committed)
            if q_s > 0.0:
                end = math.ceil(end / q_s - _EPS) * q_s
            heapq.heappush(ends, (end, next(seq), rec, run_start))
        self.busy_slots += busy
        st.waves += 1
        return len(wave)

    def next_wake(self) -> Optional[float]:
        """Earliest task end, or None when nothing is running — the single
        instant the pilot needs on the engine heap."""
        return self._ends[0][0] if self._ends else None

    # -- completion batches ------------------------------------------------
    def advance(self, now: float) -> Tuple[int, int, int]:
        """Complete every task whose end is due, consulting the fault
        oracle once per attempt; returns ``(completed, failed, requeued)``.
        Does NOT pack the freed slots — the caller packs after, so a batch
        is one advance + one pack regardless of its size."""
        ends = self._ends
        trip = self.trip
        st = self.stats
        completed = failed = 0
        retry: List[TaskRecord] = []
        freed = 0
        horizon = now + _EPS
        pop = heapq.heappop
        while ends and ends[0][0] <= horizon:
            end, _seq, rec, _run_start = pop(ends)
            freed += rec.slots
            spec = rec.spec
            if trip is not None and trip(spec.name):
                every = spec.checkpoint_every_s
                if every is not None and spec.run_time_s > every:
                    # the fault hit at attempt end: every full checkpoint
                    # segment before the final one had been committed
                    rec.committed_run_s = max(
                        rec.committed_run_s,
                        every * (math.ceil(spec.run_time_s / every - _EPS) - 1),
                    )
                rec.attempt += 1
                if rec.attempt > spec.max_retries:
                    rec.state = T_FAILED
                    failed += 1
                    self.pending_run_s -= spec.run_time_s
                    self.pending_in_bytes -= spec.stage_in_bytes
                    self.pending_out_bytes -= spec.stage_out_bytes
                else:
                    rec.state = T_PENDING
                    retry.append(rec)
            else:
                rec.state = T_DONE
                rec.finished_at = end
                completed += 1
                self.pending_run_s -= spec.run_time_s
                self.pending_in_bytes -= spec.stage_in_bytes
                self.pending_out_bytes -= spec.stage_out_bytes
        self.busy_slots -= freed
        if retry:
            st.retries += len(retry)
            # retried tasks resume at the queue head, oldest first
            self._queue.extendleft(reversed(retry))
        st.done += completed
        st.failed += failed
        return completed, failed, len(retry)

    # -- pilot-level fault path --------------------------------------------
    def interrupt(self, now: float) -> int:
        """Requeue every resident (running) task — the pilot lost its grant
        (preemption, job-level fault) or shrank (node loss). Progress up to
        the last full ``checkpoint_every_s`` segment survives; interrupted
        attempts do NOT count against ``max_retries`` (matching the
        job-level rule that preemption is not the job's fault)."""
        ends = self._ends
        if not ends:
            return 0
        retry: List[TaskRecord] = []
        # seq order == pack order: requeue preserves FIFO fairness
        for _end, _seq, rec, run_start in sorted(ends, key=lambda e: e[1]):
            spec = rec.spec
            every = spec.checkpoint_every_s
            if every is not None:
                elapsed = max(0.0, now - run_start)
                done_s = min(elapsed, spec.run_time_s - rec.committed_run_s)
                rec.committed_run_s = min(
                    spec.run_time_s,
                    rec.committed_run_s
                    + every * math.floor(done_s / every + _EPS),
                )
            rec.state = T_PENDING
            retry.append(rec)
        ends.clear()
        self.busy_slots = 0
        self._queue.extendleft(reversed(retry))
        self.stats.interrupts += 1
        return len(retry)

    # -- projection --------------------------------------------------------
    def projected_run_s(self) -> float:
        """Advisory remaining-drain estimate: the uncompleted run backlog
        spread over the effective slots, plus the remaining waves' I/O
        priced as one aggregate transfer each way. Used for the pilot's
        EASY release projection — an upper-ish bound, never a promise."""
        run = self.pending_run_s / self.effective_slots
        if self.pending_in_bytes > 0.0:
            run += self.price_in(self.pending_in_bytes)
        if self.pending_out_bytes > 0.0:
            run += self.price_out(self.pending_out_bytes)
        return run
