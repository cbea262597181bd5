"""Queueing policies: which waiting job starts when nodes free up.

The seed repo's `Scheduler.submit` hard-fails when the free pool is short;
the orchestrator instead holds a queue and consults a policy every time
capacity changes. Three policies, in increasing awareness:

* **FIFO** — strict arrival order with head-of-line blocking: if the oldest
  job doesn't fit, nothing starts (the classic batch-queue baseline).
* **Backfill** — arrival order, but jobs that fit may jump a blocked head
  (EASY-style backfill without reservations; small jobs drain around a
  large one).
* **Storage-aware** — orders by resolved *storage-node* demand, smallest
  first, so scarce DataWarp nodes turn over quickly; an aging threshold
  promotes long-waiting jobs back to arrival order to prevent starvation.
  This is the data-aware scheduling direction of Raicu et al.'s Data
  Diffusion applied to the paper's schedulable-storage model.
* **Data-aware** — the full Data Diffusion move, over the persistent-pool
  subsystem (``repro.pool``): jobs whose input datasets are already resident
  on some pool run first (their stage-in is partly or wholly a cache hit),
  ranked by resident-byte fraction; ties and pool-less jobs fall back to
  storage-aware ordering, and the same aging threshold prevents starvation
  of jobs whose data is nowhere warm.
* **EASY backfill** — arrival order, but the blocked head-of-queue job is
  given a *reservation* (the earliest instant its node demand fits, from
  the scheduler's projected-release ledger) and later jobs backfill only
  when they provably cannot delay that start. Plain backfill can starve a
  wide job indefinitely; EASY bounds its wait by the running jobs' modeled
  completions.

Preemption is a separate axis: a :class:`PreemptionPolicy` picks RUNNING
victims to checkpoint-and-release when a higher-priority arrival cannot
start (see ``Orchestrator.preempt``).

Two dispatch protocols share these policies. The legacy protocol calls
:meth:`QueuePolicy.order` — sort the whole queue, every time — and remains
the compatibility fallback for custom policies. The incremental protocol
(``orchestrator.dispatch``) never sorts the queue: it keys jobs once with
:meth:`QueuePolicy.sort_key` and re-evaluates only bucket heads, which is
valid for any policy honoring the contract documented on ``sort_key``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence

if TYPE_CHECKING:  # circular: lifecycle imports policies
    from ..core.scheduler import Scheduler
    from .lifecycle import JobRecord


class QueuePolicy(abc.ABC):
    """Orders the wait queue for dispatch; the orchestrator starts jobs in
    the returned order, stopping at the first misfit iff ``head_blocking``."""

    name: str = "abstract"
    head_blocking: bool = False
    #: aging horizon in seconds; None when keys never change as jobs wait
    aging_s: Optional[float] = None
    #: True when ``sort_key`` honors the incremental-dispatch contract
    incremental: bool = False
    #: True when the blocked head-of-queue job must receive an EASY
    #: reservation and later jobs are admitted only under its no-delay
    #: proof (the orchestrator implements the gating; the flag only asks
    #: for it)
    reserving: bool = False

    @abc.abstractmethod
    def order(
        self, queue: Sequence["JobRecord"], scheduler: "Scheduler", now: float
    ) -> list["JobRecord"]:
        ...

    def sort_key(
        self, job: "JobRecord", scheduler: "Scheduler", now: float
    ) -> tuple:
        """Key reproducing :meth:`order`: a stable sort of the queue on
        ``sort_key`` must equal ``order(queue)``.

        Incremental-dispatch contract (``orchestrator.dispatch`` relies on
        it): the key may depend on the job only through (a) its *admission
        signature* — the resolved `StorageSpec` minus the name, plus the
        compute-node count and the spec ``priority`` — (b) its
        ``submit_time``, and (c) whether it has waited past ``aging_s``;
        and, within one priority level, aged jobs must order before all
        fresh ones. Same-signature jobs then always order by
        ``(aged, bucket_subkey, arrival)``, which is what lets the dispatch
        queue maintain per-bucket order without re-sorting.

        Every stock policy ranks ``-priority`` ahead of all its own terms,
        so a preempting high-priority arrival actually receives the nodes
        its victims release (with every priority at the default 0 the
        prefix is constant and the pre-priority orderings are reproduced
        exactly).
        """
        raise NotImplementedError

    def bucket_subkey(self, job: "JobRecord") -> tuple:
        """In-bucket ordering prefix (ahead of arrival order) for the
        incremental protocol: ``()`` for pure arrival order; policies whose
        ``sort_key`` orders same-signature jobs by submit time return
        ``(job.submit_time,)``."""
        return ()


class FIFOPolicy(QueuePolicy):
    name = "fifo"
    head_blocking = True
    incremental = True

    def order(self, queue, scheduler, now):
        # arrival order within a priority level (stable sort; with every
        # priority at 0 this is exactly the arrival-ordered queue)
        return sorted(queue, key=lambda job: -job.spec.priority)

    def sort_key(self, job, scheduler, now):
        return (-job.spec.priority,)


class BackfillPolicy(QueuePolicy):
    name = "backfill"
    head_blocking = False
    incremental = True

    def order(self, queue, scheduler, now):
        return sorted(queue, key=lambda job: -job.spec.priority)

    def sort_key(self, job, scheduler, now):
        return (-job.spec.priority,)


class EasyBackfillPolicy(BackfillPolicy):
    """EASY backfill: reservations bound the head-of-queue job's wait.

    Arrival order like :class:`BackfillPolicy`, but when the head job does
    not fit, the orchestrator books it a reservation at the earliest instant
    the scheduler's projected-release ledger says its demand fits, and a
    later job may start only when it *provably* does not delay that start —
    either it leaves the head's node counts intact at the reserved instant
    even if it never finishes, or its own modeled completion lands before
    the reservation. When no reservation can be proven (the head's nodes
    are held by allocations with no release projection, e.g. persistent
    pools), nothing backfills — the guarantee degrades to head-of-line
    blocking, never to starvation. The guarantee covers *node* availability;
    pool-capacity contention is outside the ledger's vocabulary.
    """

    name = "easy-backfill"
    reserving = True


class StorageAwarePolicy(QueuePolicy):
    """Smallest storage demand first, with aging anti-starvation."""

    name = "storage-aware"
    head_blocking = False
    incremental = True

    def __init__(self, aging_s: float = 3600.0):
        if aging_s <= 0:
            raise ValueError("aging_s must be positive")
        self.aging_s = aging_s

    def sort_key(self, job, scheduler, now):
        if (now - job.submit_time) >= self.aging_s:
            return (-job.spec.priority, 0, job.submit_time, job.submit_time)
        storage = job.request.storage
        n_storage = 0 if storage is None else scheduler.resolve_storage_nodes(storage)
        return (-job.spec.priority, 1, n_storage, job.submit_time)

    def bucket_subkey(self, job):
        return (job.submit_time,)

    def order(self, queue, scheduler, now):
        return sorted(queue, key=lambda job: self.sort_key(job, scheduler, now))


class PreemptionPolicy:
    """Selects RUNNING victims to checkpoint-and-release for a blocked
    higher-priority arrival.

    The stock ranking is the classic pair: lowest priority first, and among
    equals the job with the *least* run progress — most progress protected,
    because preempting a nearly-done job wastes the most committed work
    (checkpointing bounds the loss but re-staging and redeploying are never
    free). Victims are taken greedily until their released allocations
    cover the arrival's node demand; if even every eligible victim cannot
    cover it, nothing is preempted (no pointless evictions).
    """

    def select(
        self,
        job: "JobRecord",
        candidates: Sequence["VictimView"],
        demand: tuple[int, int],
        free: tuple[int, int],
    ) -> list["JobRecord"]:
        """``candidates`` are (record, priority, progress_fraction,
        n_compute, n_storage) views of preemptible RUNNING jobs with lower
        priority than ``job``; ``demand``/``free`` are (compute, storage)
        node counts. Returns the victims to release, possibly empty."""
        need_c = demand[0] - free[0]
        need_s = demand[1] - free[1]
        victims: list = []
        for v in sorted(candidates, key=lambda v: (v.priority, v.progress, v.job.job_id)):
            if need_c <= 0 and need_s <= 0:
                break
            victims.append(v.job)
            need_c -= v.n_compute
            need_s -= v.n_storage
        if need_c > 0 or need_s > 0:
            return []
        return victims


@dataclasses.dataclass(frozen=True)
class VictimView:
    """What a :class:`PreemptionPolicy` may observe about a candidate."""

    job: "JobRecord"
    priority: int
    progress: float          # fraction of run_time_s completed so far
    n_compute: int           # nodes its release would free
    n_storage: int


class DataAwarePolicy(QueuePolicy):
    """Route jobs to their data: highest resident-byte fraction first.

    Takes anything exposing ``resident_fraction(datasets)`` — a
    :class:`~repro.provision.ProvisioningService` (the preferred handle;
    its pool catalog knows what is warm where) or a bare
    :class:`~repro.pool.PoolManager`. A job with 100% of its datasets
    resident skips all shared stage-in; starting it now both finishes it
    sooner and *keeps* those datasets pinned-warm against eviction, which
    is the Data Diffusion feedback loop (hits beget hits). Jobs with
    nothing warm are ordered by storage demand (small first), and aging
    promotes starved jobs to strict arrival order.

    Resident fractions are cached per ``(datasets, PoolManager.epoch)``:
    a dispatch round ranks every bucket head, and large campaigns share a
    handful of dataset working sets, so without the cache each round pays
    O(pools x datasets) per head. The epoch folds in the catalog version,
    so any residency change (stage-in completion, eviction, pool retire)
    invalidates exactly the stale entries.
    """

    name = "data-aware"
    head_blocking = False
    incremental = True

    def __init__(self, pools, aging_s: float = 3600.0):
        if aging_s <= 0:
            raise ValueError("aging_s must be positive")
        if not hasattr(pools, "resident_fraction"):
            raise TypeError(
                "DataAwarePolicy needs a ProvisioningService or PoolManager "
                "(anything with resident_fraction)"
            )
        self.pools = pools
        self.aging_s = aging_s
        # datasets tuple -> (pool-state token, fraction)
        self._frac_cache: dict = {}

    def _pool_state(self) -> tuple:
        """Everything a cached fraction can go stale against: the manager
        identity (services can replace theirs) and its epoch (pool set,
        lease ledgers, catalog residency all fold in)."""
        pm = getattr(self.pools, "pool_manager", self.pools)
        return (id(pm), -1 if pm is None else pm.epoch)

    def resident_fraction(self, datasets) -> float:
        state = self._pool_state()
        hit = self._frac_cache.get(datasets)
        if hit is not None and hit[0] == state:
            return hit[1]
        frac = self.pools.resident_fraction(datasets)
        self._frac_cache[datasets] = (state, frac)
        return frac

    def sort_key(self, job, scheduler, now):
        if (now - job.submit_time) >= self.aging_s:
            return (-job.spec.priority, 0, job.submit_time, 0.0, job.submit_time)
        spec = job.spec
        frac = 0.0
        if spec.wants_pool and spec.all_datasets:
            frac = self.resident_fraction(spec.all_datasets)
        storage = job.request.storage
        n_storage = 0 if storage is None else scheduler.resolve_storage_nodes(storage)
        return (-job.spec.priority, 1, -frac, n_storage, job.submit_time)

    def bucket_subkey(self, job):
        return (job.submit_time,)

    def order(self, queue, scheduler, now):
        return sorted(queue, key=lambda job: self.sort_key(job, scheduler, now))
