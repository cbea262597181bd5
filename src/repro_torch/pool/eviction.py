"""Eviction engine: free pool capacity under pressure.

A persistent pool fills up — datasets outlive the leases that staged them
(that is the point) — so admission of a new lease may need to push old
datasets out. Eviction here is *catalog-coupled*: evicting a dataset both
uncharges its bytes from the pool ledger and invalidates its catalog entry,
so the next job referencing it sees a miss and re-stages from the global FS.
Nothing is ever served from an evicted (or half-staged) tree.

Only unpinned RESIDENT entries are candidates: INFLIGHT entries belong to a
staging lease, and pinned entries may be read by a live lease. The default
policy is LRU over the catalog's last-touch stamps; alternative policies
(size-aware, cost-aware GDSF, ...) implement the same two-method interface.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING

from ..obs.trace import NULL_RECORDER
from .catalog import DataCatalog, Residency

if TYPE_CHECKING:  # avoid a cycle: manager imports eviction
    from .pool import StoragePool


class EvictionPolicy(abc.ABC):
    """Chooses victims on one pool until a byte target is met."""

    name: str = "abstract"

    @abc.abstractmethod
    def victims(
        self, pool: "StoragePool", catalog: DataCatalog, need_bytes: float
    ) -> list[Residency]:
        """Entries to evict so that ``pool.free_bytes >= need_bytes`` holds
        afterwards; empty list if the target is unreachable."""


class LRUEviction(EvictionPolicy):
    """Least-recently-touched first — Data Diffusion's baseline cache policy."""

    name = "lru"

    def victims(self, pool, catalog, need_bytes):
        shortfall = need_bytes - pool.free_bytes
        if shortfall <= 0:
            return []
        chosen: list[Residency] = []
        freed = 0.0
        for r in catalog.evictable(pool.pool_id):
            chosen.append(r)
            freed += r.dataset.nbytes
            if freed >= shortfall:
                return chosen
        return []      # even evicting everything evictable is not enough


class Evictor:
    """Applies a policy's choices: ledger uncharge + catalog invalidation."""

    def __init__(self, policy: EvictionPolicy | None = None):
        self.policy = policy or LRUEviction()
        self.evictions = 0
        self.evicted_bytes = 0.0
        # observability sink (no-op by default; PoolManager propagates its
        # recorder here). The recorder stamps virtual time itself.
        self.recorder = NULL_RECORDER

    def make_room(
        self, pool: "StoragePool", catalog: DataCatalog, need_bytes: float
    ) -> bool:
        """Evict until ``need_bytes`` fit in ``pool``; False if impossible
        (then the pool is left untouched — no partial eviction)."""
        if need_bytes <= pool.free_bytes:
            return True
        if need_bytes > pool.capacity_bytes:
            return False
        victims = self.policy.victims(pool, catalog, need_bytes)
        if not victims:
            return False
        rec = self.recorder
        for r in victims:
            catalog.invalidate(pool.pool_id, r.dataset.name)
            pool.uncharge_dataset(r.dataset.name)
            self.evictions += 1
            self.evicted_bytes += r.dataset.nbytes
            if rec.enabled:
                rec.eviction(pool.pool_id, r.dataset.name, r.dataset.nbytes)
        return pool.free_bytes >= need_bytes
