"""PoolManager: provision, lease, evict, retire persistent storage pools.

Sits between the `Scheduler`/`Provisioner` substrate and the workflow
orchestrator. Where PR 1's lifecycle provisions a fresh job-scoped file
system per job (paying the §IV-B1 fresh-deploy cost and re-staging every
shared dataset), the manager keeps long-lived pools and grants **leases**:

* ``create_pool`` pins storage nodes through an ordinary scheduler
  allocation (a node can therefore never be in two live pools — that is the
  scheduler's own no-double-allocation invariant) and plans one persistent
  deployment over them.
* ``try_acquire`` sub-allocates capacity from the best candidate pool:
  datasets already RESIDENT are cache hits (their bytes are *saved* stage-in
  traffic), missing ones are charged to the ledger as INFLIGHT and staged by
  the lease-holder; scratch is reserved on top. Under pressure the eviction
  engine pushes LRU unpinned datasets out first.
* ``release`` drops the lease's pins and scratch; an INFLIGHT dataset whose
  last pin vanishes without a completed stage-in is rolled back (uncharged),
  so a faulted stage never leaves ghost bytes in the ledger.
* Teardown happens on exactly two paths: the last lease of a ``retire()``'d
  (DRAINING) pool draining out, or ``reap_idle`` finding an ACTIVE pool with
  zero leases idle past ``ttl_s``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Optional, Sequence

from ..core.perfmodel import predict_deploy_time
from ..core.provisioner import Provisioner
from ..obs.trace import NULL_RECORDER
from ..core.scheduler import (
    AllocationError,
    JobRequest,
    Scheduler,
    StorageRequest,
)

from .catalog import DataCatalog, DatasetRef, ResidencyState, total_bytes
from .eviction import EvictionPolicy, Evictor
from .pool import Lease, PoolState, StoragePool


@dataclasses.dataclass
class PoolStats:
    """Campaign-lifetime counters (evictions live on the Evictor)."""

    dataset_hits: int = 0
    dataset_misses: int = 0
    bytes_saved: float = 0.0          # stage-in traffic avoided by hits
    bytes_staged: float = 0.0         # dataset bytes actually staged into pools
    leases_granted: int = 0
    pools_created: int = 0
    pools_retired: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.dataset_hits + self.dataset_misses
        return self.dataset_hits / total if total else 0.0


class PoolManager:
    """Owns every pool; the only object that mutates pools and the catalog."""

    def __init__(
        self,
        scheduler: Scheduler,
        provisioner: Optional[Provisioner] = None,
        *,
        catalog: Optional[DataCatalog] = None,
        eviction: Optional[EvictionPolicy] = None,
        ttl_s: Optional[float] = None,
        lease_attach_s: float = 0.1,
        clock: Optional[Callable[[], float]] = None,
    ):
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError("ttl_s must be positive (or None to disable)")
        if lease_attach_s < 0:
            raise ValueError("lease_attach_s must be >= 0")
        self.scheduler = scheduler
        self.provisioner = provisioner or Provisioner(scheduler.cluster)
        self.catalog = catalog or DataCatalog()
        self.evictor = Evictor(eviction)
        self.ttl_s = ttl_s
        self.lease_attach_s = lease_attach_s
        # default time source when callers omit ``now`` — the orchestrator
        # binds its engine clock here so mid-campaign pool operations are
        # stamped with virtual time, not 0.0
        self.clock = clock
        self.stats = PoolStats()
        self._pools: dict[int, StoragePool] = {}
        self._pool_ids = itertools.count(1)
        self._lease_ids = itertools.count(1)
        self._epoch = 0
        self._recorder = NULL_RECORDER

    @property
    def recorder(self):
        """Observability sink for pool/lease/eviction events (no-op by
        default). Assigning propagates to the evictor."""
        return self._recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        self._recorder = rec
        self.evictor.recorder = rec

    @property
    def epoch(self) -> int:
        """Monotone counter over every observable pool-state change: pool
        create/retire/teardown, lease grant/release, ledger charges, and
        catalog residency changes (the catalog's own version folds in).
        Anything cached off pool state — negotiated POOLED offers above all
        — re-validates against this instead of re-scoring every pool on
        every dispatch attempt."""
        return self._epoch + self.catalog.version

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        return self.clock() if self.clock is not None else 0.0

    # -- pool lifecycle --------------------------------------------------------
    def create_pool(
        self,
        *,
        nodes: Optional[int] = None,
        capacity_bytes: Optional[float] = None,
        capability_bw: Optional[float] = None,
        cap_bytes: Optional[float] = None,
        name: Optional[str] = None,
        runtime: str = "shifter",
        base_dir: Optional[str] = None,
        now: Optional[float] = None,
    ) -> StoragePool:
        """Provision a persistent pool sized by node count, capacity, or
        aggregate bandwidth.

        ``cap_bytes`` optionally caps the ledger below the hardware capacity
        (useful to model a quota, or to create cache pressure in benchmarks).
        Raises :class:`AllocationError` when the nodes aren't free — pools
        are deliberate, capital allocations, not opportunistic ones — and
        :class:`FSError` when ``base_dir`` is already owned by another live
        deployment or pool (two pools must never share a warm tree).
        """
        now = self._now(now)
        pool_id = next(self._pool_ids)
        name = name or f"pool{pool_id}"
        base_dir = base_dir or f"pool://{name}"
        self.provisioner.claim_tree(base_dir, owner=f"pool:{name}")
        req = StorageRequest(
            nodes=nodes, capacity_bytes=capacity_bytes, capability_bw=capability_bw
        )
        try:
            alloc = self.scheduler.submit(JobRequest(name, 0, storage=req))
        except AllocationError:
            self.provisioner.release_tree(base_dir)
            raise
        plan = self.provisioner.plan_for_nodes(alloc.storage_nodes, runtime=runtime)
        hw_capacity = sum(
            self.scheduler.policy.node_capacity_bytes(n) for n in alloc.storage_nodes
        )
        pool = StoragePool(
            pool_id=pool_id,
            name=name,
            allocation=alloc,
            plan=plan,
            fs_model=self.provisioner.model_for(plan),
            capacity_bytes=min(hw_capacity, cap_bytes) if cap_bytes else hw_capacity,
            deploy_time_s=predict_deploy_time(
                plan.targets_per_node, runtime=plan.runtime, fresh=True
            ),
            created_at=now,
            idle_since=now,        # born idle: TTL applies until the first lease
            base_dir=base_dir,
        )
        self._pools[pool_id] = pool
        self.catalog.register_pool(pool_id)
        self.stats.pools_created += 1
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.pool_created(pool, now)
        return pool

    def retire(self, pool: StoragePool, now: Optional[float] = None) -> bool:
        """Stop granting leases; tear down once (or as soon as) drained.
        Returns True if the pool was torn down immediately."""
        now = self._now(now)
        if pool.state is PoolState.RETIRED:
            raise AllocationError(f"pool {pool.name!r} is already retired")
        pool.state = PoolState.DRAINING
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.pool_retired(pool, now)
        if pool.n_leases == 0:
            self._teardown(pool, now)
            return True
        return False

    def reap_idle(self, now: Optional[float] = None) -> list[StoragePool]:
        """TTL expiry — the only teardown path besides last-lease drain."""
        now = self._now(now)
        if self.ttl_s is None:
            return []
        reaped = []
        for pool in list(self._pools.values()):
            if (
                pool.state is PoolState.ACTIVE
                and pool.n_leases == 0
                and pool.idle_since is not None
                and now - pool.idle_since >= self.ttl_s
            ):
                self._teardown(pool, now)
                reaped.append(pool)
        return reaped

    def _teardown(self, pool: StoragePool, now: float) -> None:
        assert pool.n_leases == 0, "teardown with live leases"
        self.scheduler.release(pool.allocation)
        for extra in pool.extra_allocations:
            self.scheduler.release(extra)
        pool.extra_allocations.clear()
        if pool.base_dir is not None:
            self.provisioner.release_tree(pool.base_dir)
            self.provisioner.forget_tree(pool.base_dir)
        self.catalog.drop_pool(pool.pool_id)
        pool.dataset_bytes.clear()
        pool.scratch_bytes = 0.0
        pool.state = PoolState.RETIRED
        pool.retired_at = now
        self.stats.pools_retired += 1
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.pool_torn_down(pool, now)

    # -- failure domain (chaos engine) -------------------------------------------
    def affected_pools(self, node_id: str) -> tuple[StoragePool, ...]:
        """Live pools whose backing nodes include ``node_id``."""
        return tuple(
            p for p in self.live_pools if node_id in p.storage_node_ids
        )

    def on_node_down(
        self, pool: StoragePool, node_id: str, now: Optional[float] = None
    ) -> None:
        """Absorb the loss of one backing node.

        Striping puts every dataset on every node, so the pool's residency
        is invalidated wholesale: every unpinned catalog entry drops (the
        next reference is a miss that re-stages — evicted data is never
        served stale) and its ledger bytes are uncharged. Callers fail the
        pool's leaseholders *first* (releasing their leases unpins), so by
        the time this runs nothing should still be pinned. Capacity shrinks
        by what the *surviving* backing hardware can no longer cover — a
        ledger quota sitting below hardware may lose nothing at all; a pool
        that loses its last backing node is retired outright. Healing —
        :meth:`backfill` on a retry policy, or the node's own repair via
        :meth:`on_node_repair` — restores exactly the share deducted here.
        """
        now = self._now(now)
        if node_id in pool.dead_node_capacity or node_id in pool.replaced_node_ids:
            return
        node = next(
            (n for n in pool.allocation.storage_nodes if n.node_id == node_id), None
        )
        if node is None:
            # a backfill spare died: drop its allocation back to the
            # scheduler (which parks the dead node) and shed its share
            for extra in list(pool.extra_allocations):
                if any(n.node_id == node_id for n in extra.storage_nodes):
                    share = self._capacity_loss(pool, node_id)
                    pool.extra_allocations.remove(extra)
                    self._invalidate_residency(pool)
                    pool.capacity_bytes -= share
                    self.scheduler.release(extra)
                    break
            self._epoch += 1
            return
        self._invalidate_residency(pool)
        share = self._capacity_loss(pool, node_id)
        pool.capacity_bytes -= share
        pool.dead_node_capacity[node_id] = share
        self._epoch += 1
        if not pool.storage_node_ids and pool.state is PoolState.ACTIVE:
            # nothing left to serve from: stop granting; the last lease
            # drain (or this call, if none are live) tears it down
            self.retire(pool, now)

    def _capacity_loss(self, pool: StoragePool, node_id: str) -> float:
        """Ledger bytes the pool loses with ``node_id`` gone: only what the
        surviving backing hardware cannot absorb (the ledger quota may sit
        well below hardware, in which case a node loss costs nothing)."""
        cap = self.scheduler.policy.node_capacity_bytes
        alive_hw = sum(
            cap(n)
            for n in pool.allocation.storage_nodes
            if n.node_id != node_id
            and n.node_id not in pool.dead_node_capacity
            and n.node_id not in pool.replaced_node_ids
        )
        alive_hw += sum(
            cap(n)
            for extra in pool.extra_allocations
            for n in extra.storage_nodes
            if n.node_id != node_id
        )
        return pool.capacity_bytes - min(pool.capacity_bytes, alive_hw)

    def _invalidate_residency(self, pool: StoragePool) -> None:
        """Drop every unpinned catalog entry (and its ledger charge)."""
        for r in self.catalog.entries(pool.pool_id):
            if r.pins == 0:
                self.catalog.invalidate(pool.pool_id, r.dataset.name)
                pool.uncharge_dataset(r.dataset.name)

    def on_node_repair(self, node_id: str, now: Optional[float] = None) -> None:
        """A dead node came back: pools still waiting on it re-silver it
        (capacity restored); pools that already backfilled past it keep
        their spare and leave the repaired chassis idle in the allocation."""
        now = self._now(now)
        for pool in self.live_pools:
            share = pool.dead_node_capacity.pop(node_id, None)
            if share is not None:
                pool.capacity_bytes += share
                self._epoch += 1
                rec = self._recorder
                if rec.enabled:
                    rec.rebuild(pool, node_id, via="repair", t=now)

    def backfill(self, pool: StoragePool, now: Optional[float] = None) -> bool:
        """One self-heal attempt: claim a free storage node to replace the
        longest-dead unreplaced node. Returns True when a spare was granted
        (capacity restored); False when the cluster has no free node right
        now — callers retry on a :class:`~repro.chaos.RetryPolicy` cadence.
        """
        now = self._now(now)
        if not pool.dead_node_capacity or pool.state is not PoolState.ACTIVE:
            return False
        dead_id = min(pool.dead_node_capacity)
        alloc = self.scheduler.try_submit(
            JobRequest(
                f"{pool.name}-heal-{dead_id}", 0, storage=StorageRequest(nodes=1)
            )
        )
        if alloc is None:
            return False
        share = pool.dead_node_capacity.pop(dead_id)
        pool.replaced_node_ids.add(dead_id)
        pool.extra_allocations.append(alloc)
        pool.capacity_bytes += share
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.rebuild(pool, dead_id, via="backfill", t=now)
        return True

    # -- introspection -----------------------------------------------------------
    @property
    def pools(self) -> tuple[StoragePool, ...]:
        return tuple(self._pools.values())

    @property
    def live_pools(self) -> tuple[StoragePool, ...]:
        return tuple(p for p in self._pools.values() if p.state is not PoolState.RETIRED)

    @property
    def active_pools(self) -> tuple[StoragePool, ...]:
        return tuple(p for p in self._pools.values() if p.state is PoolState.ACTIVE)

    def get(self, pool_id: int) -> StoragePool:
        return self._pools[pool_id]

    def occupancy(self) -> float:
        """Mean ledger occupancy over live pools (a campaign-report metric)."""
        live = self.live_pools
        return sum(p.occupancy for p in live) / len(live) if live else 0.0

    def feasible(
        self, datasets: Sequence[DatasetRef], scratch_bytes: float = 0.0
    ) -> bool:
        """Could some pool *ever* hold this working set (full capacity,
        worst case of nothing resident)? The orchestrator's fail-fast check
        for pool-backed jobs. Only ACTIVE pools count: a DRAINING pool never
        grants another lease, so its capacity is a promise that cannot be
        kept."""
        need = total_bytes(datasets) + scratch_bytes
        return any(p.capacity_bytes >= need for p in self.active_pools)

    def resident_fraction(self, datasets: Sequence[DatasetRef]) -> float:
        """Best-pool fraction of these datasets' bytes already resident —
        the ranking signal for ``DataAwarePolicy``."""
        total = total_bytes(datasets)
        if total <= 0 or not self.active_pools:
            return 0.0
        return max(
            self.catalog.resident_bytes(p.pool_id, datasets) / total
            for p in self.active_pools
        )

    # -- leasing -----------------------------------------------------------------
    def try_acquire(
        self,
        job_name: str,
        datasets: Iterable[DatasetRef],
        scratch_bytes: float = 0.0,
        *,
        now: Optional[float] = None,
    ) -> Optional[Lease]:
        """Grant a lease from the best candidate pool, or None if no ACTIVE
        pool can fit the working set right now (callers keep the job queued).

        Candidates are ranked data-aware: most resident bytes for these
        datasets first, then most free space.
        """
        now = self._now(now)
        datasets = tuple(datasets)
        ranked = sorted(
            self.active_pools,
            key=lambda p: (
                -self.catalog.resident_bytes(p.pool_id, datasets),
                -p.free_bytes,
                p.pool_id,
            ),
        )
        for pool in ranked:
            lease = self._acquire_on(pool, job_name, datasets, scratch_bytes, now)
            if lease is not None:
                return lease
        return None

    def _acquire_on(
        self,
        pool: StoragePool,
        job_name: str,
        datasets: tuple[DatasetRef, ...],
        scratch_bytes: float,
        now: float,
    ) -> Optional[Lease]:
        if len({d.name for d in datasets}) != len(datasets):
            raise ValueError(f"{job_name!r}: duplicate dataset names in request")
        tracked = [d for d in datasets if self.catalog.lookup(pool.pool_id, d.name)]
        hits = [d for d in tracked if self.catalog.resident(pool.pool_id, d.name)]
        missing = [d for d in datasets if d not in hits]
        to_charge = [d for d in missing if d not in tracked]   # untracked misses
        need = scratch_bytes + sum(d.nbytes for d in to_charge)

        # Pin what we will read *before* evicting, so the eviction pass can
        # neither victimize this lease's hits nor a sibling's inflight stage.
        for d in tracked:
            self.catalog.pin(pool.pool_id, d.name)
        if not self.evictor.make_room(pool, self.catalog, need):
            for d in tracked:
                self.catalog.unpin(pool.pool_id, d.name)
            return None

        for d in to_charge:
            pool.charge_dataset(d)
            self.catalog.add(pool.pool_id, d, now)   # INFLIGHT until staged
            self.catalog.pin(pool.pool_id, d.name)
        pool.reserve_scratch(scratch_bytes)
        for d in hits:
            self.catalog.touch(pool.pool_id, d.name, now)

        lease = Lease(
            lease_id=next(self._lease_ids),
            pool_id=pool.pool_id,
            job_name=job_name,
            scratch_bytes=scratch_bytes,
            datasets=datasets,
            missing=tuple(missing),
            resident_bytes=sum(d.nbytes for d in hits),
            granted_at=now,
        )
        pool.attach(lease)
        self.stats.leases_granted += 1
        self.stats.dataset_hits += len(hits)
        self.stats.dataset_misses += len(missing)
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.lease_attached(lease, pool, len(hits), len(missing), now)
        return lease

    def on_stage_in_complete(self, lease: Lease, now: Optional[float] = None) -> None:
        """The lease-holder finished staging its missing datasets: they are
        now servable (RESIDENT) for every later job routed to this pool.

        Byte counters live here, not at grant time: an attempt that faults
        before its stage-in completes neither staged nor saved anything, so
        ``bytes_saved`` and ``bytes_staged`` stay mutually consistent under
        retries."""
        now = self._now(now)
        self.stats.bytes_saved += lease.resident_bytes
        for d in lease.missing:
            entry = self.catalog.lookup(lease.pool_id, d.name)
            if entry is not None and entry.state is ResidencyState.INFLIGHT:
                self.catalog.mark_resident(lease.pool_id, d.name, now)
            self.stats.bytes_staged += d.nbytes
        for d in lease.datasets:
            self.catalog.touch(lease.pool_id, d.name, now)

    def release(self, lease: Lease, now: Optional[float] = None) -> bool:
        """Drop a lease: unpin datasets, roll back unfinished stages, free
        scratch. Returns True if this was the last lease of a DRAINING pool
        and the pool was torn down."""
        now = self._now(now)
        pool = self._pools[lease.pool_id]
        for d in lease.datasets:
            entry = self.catalog.lookup(pool.pool_id, d.name)
            if entry is None:
                continue
            self.catalog.unpin(pool.pool_id, d.name)
            if entry.pins == 0 and entry.state is ResidencyState.INFLIGHT:
                # the stage never completed (fault mid stage-in): no ghost bytes
                self.catalog.invalidate(pool.pool_id, d.name)
                pool.uncharge_dataset(d.name)
        pool.release_scratch(lease.scratch_bytes)
        pool.detach(lease.lease_id, now)
        self._epoch += 1
        rec = self._recorder
        if rec.enabled:
            rec.lease_released(lease, now)
        if pool.state is PoolState.DRAINING and pool.n_leases == 0:
            self._teardown(pool, now)
            return True
        return False

    # -- invariants (exercised by the property tests) -----------------------------
    def check_invariants(self) -> None:
        seen_nodes: set[str] = set()
        for pool in self.live_pools:
            pool.check_invariants()
            ids = pool.storage_node_ids
            assert not ids & seen_nodes, f"node in two live pools: {ids & seen_nodes}"
            seen_nodes |= ids
            charged = set(pool.dataset_bytes)
            tracked = {r.dataset.name for r in self.catalog.entries(pool.pool_id)}
            assert charged == tracked, (
                f"pool {pool.name!r}: ledger/catalog drift "
                f"{charged ^ tracked}"
            )
