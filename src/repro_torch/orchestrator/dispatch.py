"""Indexed dispatch queue: incremental job admission for large campaigns.

The legacy dispatch loop re-sorts the whole wait queue (``policy.order``),
re-resolves every queued job's demand, and removes an admitted job with an
O(Q) list scan — once per admitted job, so a campaign of N jobs pays
O(N²·log N) in the dispatcher alone. This module replaces that with an
indexed structure without changing any observable scheduling decision:

* Jobs are grouped into **buckets** by *admission signature* — everything
  the provisioning path can observe about a job except its name: the
  resolved `StorageSpec`'s fields plus the compute-node count (PERSISTENT
  specs also carry their name, because pool creation is
  idempotent-by-name). Same-signature jobs are interchangeable to every
  admission check: negotiation sees the same spec, the scheduler resolves
  the same demand, a pool sees the same working set. If the first of them
  in policy order cannot start right now, neither can the rest — so one
  probe per *bucket* replaces one probe per *job*.
* Within a bucket, the built-in policies order jobs by
  ``(aged, bucket_subkey, arrival seq)`` — the incremental contract
  documented on :meth:`QueuePolicy.sort_key` — which is invariant under
  free-pool and catalog changes. In-bucket order is therefore maintained
  once, in two lazy-deletion heaps (aged / fresh) per bucket.
* Across buckets only the bucket *heads* are compared, with the policy's
  full ``sort_key`` (storage demand against the live free pool, resident
  fraction against the live catalog, ...) computed fresh per dispatch
  round: O(buckets · log buckets), not O(queue · log queue).
* Aging promotions are driven by a global min-heap on each job's promotion
  instant, so a job moves to the aged class exactly when the legacy sort
  would have reclassified it.
"""

from __future__ import annotations

import heapq
import itertools
from typing import TYPE_CHECKING, Optional

from ..provision.spec import LifetimeClass

if TYPE_CHECKING:
    from ..core.scheduler import Scheduler
    from .lifecycle import JobRecord
    from .policies import QueuePolicy


def admission_signature(job: "JobRecord") -> tuple:
    """Everything admission can observe about a queued job except its name
    (plus the name for PERSISTENT specs — pool creation is idempotent by
    name, so two PERSISTENT jobs with different names are *not*
    interchangeable: one may reattach to a live pool the other cannot).

    Resume state (``committed_run_s``, ``staged_nodes``, the restore bytes
    a cold landing re-reads) is deliberately **excluded**: it moves a
    session's modeled *time* costs but never its grant/deny answer, so a
    checkpoint-resuming requeue keeps the same admission-signature bucket
    rank as a fresh attempt of the same spec — which is what keeps
    one-probe-per-bucket dispatch sound with fault tolerance on.

    ``priority`` *is* included — not because admission sees it, but because
    every stock policy ranks it ahead of its own terms, and in-bucket order
    is maintained priority-blind; same-priority jobs are still one bucket."""
    sspec = job.sspec
    sig = sspec.signature()
    if sspec.lifetime is LifetimeClass.PERSISTENT:
        sig = sig + (sspec.name,)
    return (job.spec.n_compute, job.spec.priority, sig)


class _Entry:
    """One enqueued attempt of a job (a requeue creates a fresh entry)."""

    __slots__ = ("job", "seq", "aged", "alive", "bucket")

    def __init__(self, job: "JobRecord", seq: int, aged: bool, bucket: "_Bucket"):
        self.job = job
        self.seq = seq
        self.aged = aged
        self.alive = True
        self.bucket = bucket


class _Bucket:
    """Jobs sharing one admission signature, in policy order.

    Heap items are ``(subkey..., seq, entry)``; the aged heap orders before
    the fresh heap (every built-in policy ranks aged jobs first)."""

    __slots__ = ("signature", "aged", "fresh", "n_live")

    def __init__(self, signature: tuple):
        self.signature = signature
        self.aged: list = []
        self.fresh: list = []
        self.n_live = 0

    def push(self, entry: _Entry, subkey: tuple) -> None:
        heap = self.aged if entry.aged else self.fresh
        heapq.heappush(heap, (*subkey, entry.seq, entry))
        self.n_live += 1

    def head(self) -> Optional[_Entry]:
        """Live entry first in in-bucket order (lazy-dropping removed and
        promoted-away entries from the heap heads)."""
        aged = self.aged
        while aged and not aged[0][-1].alive:
            heapq.heappop(aged)
        if aged:
            return aged[0][-1]
        fresh = self.fresh
        while fresh and (not fresh[0][-1].alive or fresh[0][-1].aged):
            heapq.heappop(fresh)
        return fresh[0][-1] if fresh else None


class DispatchQueue:
    """The orchestrator's wait queue, indexed for O(buckets) dispatch."""

    def __init__(self, policy: "QueuePolicy", scheduler: "Scheduler"):
        self.policy = policy
        self.scheduler = scheduler
        self._buckets: dict[tuple, _Bucket] = {}
        self._entries: dict[int, _Entry] = {}        # job_id -> live entry
        self._seq = itertools.count()
        # (promotion instant, seq, entry) for not-yet-aged jobs
        self._promotions: list = []

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, job: "JobRecord") -> bool:
        return job.job_id in self._entries

    def add(self, job: "JobRecord", now: float) -> None:
        if job.job_id in self._entries:
            raise ValueError(f"{job.spec.name!r} is already queued")
        sig = admission_signature(job)
        bucket = self._buckets.get(sig)
        if bucket is None:
            bucket = self._buckets[sig] = _Bucket(sig)
        aging = self.policy.aging_s
        aged = aging is not None and (now - job.submit_time) >= aging
        entry = _Entry(job, next(self._seq), aged, bucket)
        self._entries[job.job_id] = entry
        bucket.push(entry, self.policy.bucket_subkey(job))
        if aging is not None and not aged:
            heapq.heappush(
                self._promotions, (job.submit_time + aging, entry.seq, entry)
            )

    def remove(self, job: "JobRecord") -> None:
        entry = self._entries.pop(job.job_id)
        entry.alive = False
        bucket = entry.bucket
        bucket.n_live -= 1
        if bucket.n_live == 0:
            # dropping the bucket also drops its dead heap entries
            del self._buckets[bucket.signature]

    def promote(self, now: float) -> None:
        """Move every job whose wait crossed ``aging_s`` to the aged class —
        exactly the reclassification the legacy full sort would apply."""
        promos = self._promotions
        while promos and promos[0][0] <= now:
            _, _, entry = heapq.heappop(promos)
            if entry.alive and not entry.aged:
                entry.aged = True
                bucket = entry.bucket
                heapq.heappush(
                    bucket.aged,
                    (*self.policy.bucket_subkey(entry.job), entry.seq, entry),
                )

    def candidate_heads(self, now: float, gate=None) -> list:
        """``(key, seq, job, bucket)`` for every bucket head. Heapified by
        the caller, this is the legacy policy order restricted to heads
        (seq is unique, so job/bucket never enter the comparison).

        ``gate`` (e.g. the orchestrator's O(1) admissibility pre-filter)
        drops heads that would certainly be refused, before paying for
        their policy keys — sound because a gated-out probe is
        side-effect-free in the legacy scan too."""
        policy, scheduler = self.policy, self.scheduler
        out = []
        for bucket in self._buckets.values():
            entry = bucket.head()
            if entry is None or (gate is not None and not gate(entry.job)):
                continue
            out.append(
                (policy.sort_key(entry.job, scheduler, now), entry.seq, entry.job, bucket)
            )
        return out

    def head_item(self, bucket: _Bucket, now: float, gate=None) -> Optional[tuple]:
        """Fresh candidate tuple for one bucket (after its head changed)."""
        entry = bucket.head()
        if entry is None or (gate is not None and not gate(entry.job)):
            return None
        key = self.policy.sort_key(entry.job, self.scheduler, now)
        return (key, entry.seq, entry.job, bucket)

    def is_bucket_head(self, job: "JobRecord") -> bool:
        entry = self._entries[job.job_id]
        return entry.bucket.head() is entry

    def seq_of(self, job: "JobRecord") -> int:
        return self._entries[job.job_id].seq

    def jobs(self) -> list:
        """Snapshot of queued jobs in arrival order (``Orchestrator.queue``)."""
        return [
            e.job for e in sorted(self._entries.values(), key=lambda e: e.seq)
        ]
