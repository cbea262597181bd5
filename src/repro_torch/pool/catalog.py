"""Data-aware catalog: which datasets are resident on which storage pool.

Data Diffusion (Raicu et al.) schedules work *to the data*: provisioned
storage acts as a cache of the global file system, and the scheduler needs a
catalog mapping logical dataset names to the pools whose trees already hold
them. This module is that catalog. Residency is tracked per (pool, dataset)
with an explicit state machine:

    INFLIGHT  -- a lease is staging the dataset in; its bytes are charged to
                 the pool ledger but the data is not yet servable. A second
                 job referencing it counts as a *miss* (it re-models the
                 stage time) but must not double-charge the ledger.
    RESIDENT  -- staged and servable; a referencing job is a cache *hit*.

Eviction invalidates the entry outright — there is no "stale" state a reader
could be served from; the next reference is a miss and re-stages (the
acceptance invariant: evicted datasets are re-staged, never served stale).
Pins (one per live lease referencing the entry) make an entry ineligible for
eviction while any job may read it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DatasetRef:
    """A logical dataset: name -> bytes (optionally a global-FS tree path)."""

    name: str
    nbytes: float
    tree: Optional[str] = None          # source directory on the global FS

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("dataset name must be non-empty")
        if self.nbytes <= 0:
            raise ValueError(f"dataset {self.name!r}: nbytes must be positive")


class ResidencyState(enum.Enum):
    INFLIGHT = "inflight"
    RESIDENT = "resident"


@dataclasses.dataclass
class Residency:
    """One dataset's presence on one pool."""

    dataset: DatasetRef
    pool_id: int
    state: ResidencyState
    pins: int = 0
    last_touch: float = 0.0
    staged_at: Optional[float] = None

    @property
    def evictable(self) -> bool:
        return self.pins == 0 and self.state is ResidencyState.RESIDENT


class DataCatalog:
    """Residency index over every live pool; the routing side of the pool
    subsystem (``DataAwarePolicy`` ranks queued jobs by what it answers)."""

    def __init__(self) -> None:
        self._by_pool: dict[int, dict[str, Residency]] = {}
        #: bumped on every mutation that can change what is resident where
        #: (add / mark_resident / invalidate / drop_pool — not touch or
        #: pin, which only steer eviction). Consumers caching anything
        #: derived from residency (negotiated offers, data-aware policy
        #: keys) invalidate against it.
        self.version = 0

    # -- pool lifecycle -------------------------------------------------------
    def register_pool(self, pool_id: int) -> None:
        if pool_id in self._by_pool:
            raise ValueError(f"pool {pool_id} already registered")
        self._by_pool[pool_id] = {}

    def drop_pool(self, pool_id: int) -> list[Residency]:
        """Pool teardown: every entry vanishes with the pool's tree."""
        self.version += 1
        return list(self._by_pool.pop(pool_id, {}).values())

    # -- lookups --------------------------------------------------------------
    def lookup(self, pool_id: int, name: str) -> Optional[Residency]:
        return self._by_pool.get(pool_id, {}).get(name)

    def resident(self, pool_id: int, name: str) -> bool:
        r = self.lookup(pool_id, name)
        return r is not None and r.state is ResidencyState.RESIDENT

    def pools_holding(self, name: str) -> list[int]:
        """Pools on which ``name`` is RESIDENT (servable right now)."""
        return [
            pid
            for pid, entries in self._by_pool.items()
            if (r := entries.get(name)) is not None
            and r.state is ResidencyState.RESIDENT
        ]

    def resident_bytes(self, pool_id: int, datasets: Sequence[DatasetRef]) -> float:
        """Bytes of ``datasets`` servable from ``pool_id`` (the hit volume)."""
        return sum(d.nbytes for d in datasets if self.resident(pool_id, d.name))

    def entries(self, pool_id: int) -> tuple[Residency, ...]:
        return tuple(self._by_pool.get(pool_id, {}).values())

    # -- mutation (driven by the PoolManager) ---------------------------------
    def add(
        self,
        pool_id: int,
        dataset: DatasetRef,
        now: float,
        *,
        state: ResidencyState = ResidencyState.INFLIGHT,
    ) -> Residency:
        entries = self._by_pool[pool_id]
        if dataset.name in entries:
            raise ValueError(f"{dataset.name!r} already tracked on pool {pool_id}")
        r = Residency(dataset=dataset, pool_id=pool_id, state=state, last_touch=now)
        entries[dataset.name] = r
        self.version += 1
        return r

    def mark_resident(self, pool_id: int, name: str, now: float) -> None:
        r = self._require(pool_id, name)
        r.state = ResidencyState.RESIDENT
        r.staged_at = now
        r.last_touch = now
        self.version += 1

    def touch(self, pool_id: int, name: str, now: float) -> None:
        self._require(pool_id, name).last_touch = now

    def pin(self, pool_id: int, name: str) -> None:
        self._require(pool_id, name).pins += 1

    def unpin(self, pool_id: int, name: str) -> None:
        r = self._require(pool_id, name)
        if r.pins <= 0:
            raise ValueError(f"{name!r} on pool {pool_id} is not pinned")
        r.pins -= 1

    def invalidate(self, pool_id: int, name: str) -> Residency:
        """Remove an entry (eviction, or an INFLIGHT stage that failed).

        Pinned entries cannot be invalidated: a live lease may read them.
        """
        r = self._require(pool_id, name)
        if r.pins > 0:
            raise ValueError(f"cannot invalidate pinned {name!r} on pool {pool_id}")
        del self._by_pool[pool_id][name]
        self.version += 1
        return r

    # -- eviction support ------------------------------------------------------
    def evictable(self, pool_id: int) -> list[Residency]:
        """Unpinned RESIDENT entries, least-recently-touched first (LRU)."""
        return sorted(
            (r for r in self._by_pool.get(pool_id, {}).values() if r.evictable),
            key=lambda r: (r.last_touch, r.dataset.name),
        )

    def _require(self, pool_id: int, name: str) -> Residency:
        r = self.lookup(pool_id, name)
        if r is None:
            raise KeyError(f"dataset {name!r} not tracked on pool {pool_id}")
        return r


def total_bytes(datasets: Iterable[DatasetRef]) -> float:
    return sum(d.nbytes for d in datasets)
