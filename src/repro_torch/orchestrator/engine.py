"""Event-driven simulation engine with a virtual clock.

The orchestrator advances time by *model predictions* (deploy time C8,
staging bandwidth, run time), not wallclock: a campaign of hundreds of jobs
— each spending modeled minutes in provisioning, staging, and compute —
executes in milliseconds of real time. Classic discrete-event simulation:
a min-heap of timestamped callbacks, popped in (time, insertion) order so
simultaneous events fire FIFO.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Iterable, Optional


class SimEngine:
    """A discrete-event loop over a virtual clock."""

    #: How many processed events between recorder heap-depth samples.
    SAMPLE_EVERY = 512

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._events_processed = 0
        # observability: an enabled repro.obs.trace recorder gets periodic
        # heap-depth samples from run(); None / NullRecorder cost one local
        # truthiness check per event
        self.recorder = None

    @property
    def now(self) -> float:
        """Current virtual time (seconds)."""
        return self._now

    @property
    def events_processed(self) -> int:
        return self._events_processed

    def __len__(self) -> int:
        return len(self._heap)

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to fire at virtual time ``t``."""
        if t < self._now:
            raise ValueError(f"cannot schedule at {t} < now {self._now}")
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to fire ``delay`` seconds from now."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        self.at(self._now + delay, fn)

    def at_many(self, events: Iterable[tuple[float, Callable[[], None]]]) -> None:
        """Bulk-schedule ``(time, fn)`` pairs: one heapify instead of a push
        per event, for campaign submission bursts. Sequence numbers are
        assigned in iteration order, so simultaneous events still fire FIFO
        exactly as the equivalent sequence of :meth:`at` calls would (the
        pop order of a heap is determined by its entries alone)."""
        batch = []
        for t, fn in events:
            if t < self._now:
                raise ValueError(f"cannot schedule at {t} < now {self._now}")
            batch.append((t, next(self._seq), fn))
        if not batch:
            return
        if len(batch) > 8 and len(batch) * 4 > len(self._heap):
            self._heap.extend(batch)
            heapq.heapify(self._heap)
        else:
            for entry in batch:
                heapq.heappush(self._heap, entry)

    def run(
        self,
        until: Optional[float] = None,
        max_events: Optional[int] = 1_000_000,
    ) -> float:
        """Drain the event heap; returns the final virtual time.

        ``until`` stops the clock at that time, leaving later events queued.
        ``max_events`` guards against a pathological self-rescheduling loop;
        pass ``None`` to disable the backstop (large campaigns legitimately
        process many millions of events).
        """
        processed = 0
        heap = self._heap
        pop = heapq.heappop
        rec = self.recorder
        if rec is not None and not rec.enabled:
            rec = None
        sample_mask = self.SAMPLE_EVERY - 1
        while heap:
            if until is not None and heap[0][0] > until:
                self._now = until
                return self._now
            t, _, fn = pop(heap)
            self._now = t
            fn()
            processed += 1
            self._events_processed += 1
            if rec is not None and not (self._events_processed & sample_mask):
                rec.engine_sample(self._now, len(heap), self._events_processed)
            if max_events is not None and processed >= max_events:
                raise RuntimeError(
                    f"engine processed {max_events} events without draining; "
                    f"likely an event loop (now={self._now})"
                )
        if until is not None and until > self._now:
            self._now = until
        if rec is not None and processed:
            # closing sample: short runs (< SAMPLE_EVERY events) still get
            # at least one, and every trace ends with a drained-heap point
            rec.engine_sample(self._now, len(heap), self._events_processed)
        return self._now
