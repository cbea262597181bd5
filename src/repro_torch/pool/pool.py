"""StoragePool: a long-lived deployment plus a capacity ledger and leases.

The paper tears its BeeGFS instance down with the job; DataWarp's own
*persistent instance* mode (and Merzky et al.'s pilot abstraction) instead
keeps one provisioned instance alive across many jobs and sub-allocates it.
A ``StoragePool`` is that persistent instance in this codebase: it pins its
storage nodes through an ordinary scheduler allocation (so the scheduler's
no-double-allocation invariant extends to pools for free), carries the
analytic `FSDeployment` every lease-holder stages against, and accounts every
byte in a ledger:

    used = sum(charged dataset bytes) + sum(lease scratch reservations)

The ledger can never exceed capacity — ``charge_dataset`` / ``reserve_scratch``
raise :class:`PoolCapacityError` instead of oversubscribing, and callers
(the PoolManager) evict to make room *before* charging.

Teardown discipline (property-tested): a pool dies only when its last lease
drains after ``retire()``, or when it sits idle (zero leases) past the
manager's TTL. Nothing else releases its nodes.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from ..core.perfmodel import FSDeployment
from ..core.provisioner import DeploymentPlan
from ..core.scheduler import Allocation

from .catalog import DatasetRef


class PoolError(RuntimeError):
    pass


class PoolCapacityError(PoolError):
    """Raised instead of ever letting the ledger exceed capacity."""


class PoolState(enum.Enum):
    ACTIVE = "active"          # granting leases
    DRAINING = "draining"      # retired; existing leases run out, no new ones
    RETIRED = "retired"        # torn down; nodes returned to the scheduler


@dataclasses.dataclass(frozen=True)
class Lease:
    """A job's sub-allocation of a pool: scratch space plus dataset pins."""

    lease_id: int
    pool_id: int
    job_name: str
    scratch_bytes: float
    datasets: tuple[DatasetRef, ...]      # everything the job references
    missing: tuple[DatasetRef, ...]       # misses at acquire time: must stage
    resident_bytes: float                 # hit volume: stage-in bytes saved
    granted_at: float

    @property
    def hits(self) -> int:
        return len(self.datasets) - len(self.missing)

    @property
    def misses(self) -> int:
        return len(self.missing)


@dataclasses.dataclass
class StoragePool:
    """One persistent provisioned instance. Mutated only by the PoolManager."""

    pool_id: int
    name: str
    allocation: Allocation                # pins the storage nodes
    plan: DeploymentPlan
    fs_model: FSDeployment
    capacity_bytes: float
    deploy_time_s: float                  # one-time fresh deploy (C8)
    created_at: float
    state: PoolState = PoolState.ACTIVE
    base_dir: Optional[str] = None        # claimed tree (collision-guarded)
    idle_since: Optional[float] = None    # set while zero leases are live
    retired_at: Optional[float] = None
    leases: dict = dataclasses.field(default_factory=dict)       # id -> Lease
    dataset_bytes: dict = dataclasses.field(default_factory=dict)  # name -> bytes
    scratch_bytes: float = 0.0
    # -- failure domain (chaos engine) ----------------------------------------
    #: dead original nodes awaiting heal: node_id -> capacity share deducted
    #: when the node died (restored exactly on repair or replacement)
    dead_node_capacity: dict = dataclasses.field(default_factory=dict)
    #: original nodes replaced by a backfill node: still pinned by the
    #: pool's allocation (released at teardown) but no longer backing it
    replaced_node_ids: set = dataclasses.field(default_factory=set)
    #: backfill allocations (one spare node each), released at teardown
    extra_allocations: list = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.capacity_bytes <= 0:
            raise ValueError(f"pool {self.name!r}: capacity must be positive")
        if not self.allocation.storage_nodes:
            raise ValueError(f"pool {self.name!r}: allocation has no storage nodes")

    # -- ledger ---------------------------------------------------------------
    @property
    def used_bytes(self) -> float:
        return sum(self.dataset_bytes.values()) + self.scratch_bytes

    @property
    def free_bytes(self) -> float:
        return self.capacity_bytes - self.used_bytes

    @property
    def occupancy(self) -> float:
        # a fully-degraded pool (every node dead, capacity 0) counts as full
        if self.capacity_bytes <= 0:
            return 1.0
        return self.used_bytes / self.capacity_bytes

    def charge_dataset(self, dataset: DatasetRef) -> None:
        """Charge a dataset's bytes once; idempotent for an already-charged
        name (a second lease staging behind an INFLIGHT entry)."""
        if dataset.name in self.dataset_bytes:
            return
        if dataset.nbytes > self.free_bytes:
            raise PoolCapacityError(
                f"pool {self.name!r}: dataset {dataset.name!r} "
                f"({dataset.nbytes:.3g} B) exceeds free {self.free_bytes:.3g} B"
            )
        self.dataset_bytes[dataset.name] = dataset.nbytes

    def uncharge_dataset(self, name: str) -> float:
        return self.dataset_bytes.pop(name, 0.0)

    def reserve_scratch(self, nbytes: float) -> None:
        if nbytes < 0:
            raise ValueError("scratch reservation must be >= 0")
        if nbytes > self.free_bytes:
            raise PoolCapacityError(
                f"pool {self.name!r}: scratch {nbytes:.3g} B "
                f"exceeds free {self.free_bytes:.3g} B"
            )
        self.scratch_bytes += nbytes

    def release_scratch(self, nbytes: float) -> None:
        # float accumulation at GB scale: tolerate relative rounding drift
        if nbytes > self.scratch_bytes and not math.isclose(
            nbytes, self.scratch_bytes, rel_tol=1e-9, abs_tol=1e-6
        ):
            raise PoolError(
                f"pool {self.name!r}: releasing {nbytes:.3g} B scratch, "
                f"only {self.scratch_bytes:.3g} B reserved"
            )
        self.scratch_bytes = max(0.0, self.scratch_bytes - nbytes)

    # -- leases ----------------------------------------------------------------
    @property
    def n_leases(self) -> int:
        return len(self.leases)

    def attach(self, lease: Lease) -> None:
        if self.state is not PoolState.ACTIVE:
            raise PoolError(f"pool {self.name!r} is {self.state.value}, not leasable")
        self.leases[lease.lease_id] = lease
        self.idle_since = None

    def detach(self, lease_id: int, now: float) -> None:
        if lease_id not in self.leases:
            raise PoolError(f"lease {lease_id} is not attached to pool {self.name!r}")
        del self.leases[lease_id]
        if not self.leases:
            self.idle_since = now

    # -- introspection ----------------------------------------------------------
    @property
    def storage_node_ids(self) -> frozenset:
        """Ids of the nodes currently *backing* the pool: the original
        allocation minus dead/replaced nodes, plus backfill spares."""
        ids = {
            n.node_id
            for n in self.allocation.storage_nodes
            if n.node_id not in self.dead_node_capacity
            and n.node_id not in self.replaced_node_ids
        }
        for alloc in self.extra_allocations:
            ids.update(n.node_id for n in alloc.storage_nodes)
        return frozenset(ids)

    @property
    def degraded(self) -> bool:
        """True while any original node is dead and unreplaced."""
        return bool(self.dead_node_capacity)

    def check_invariants(self) -> None:
        """Ledger sanity; tests call this after every operation."""
        assert self.used_bytes <= self.capacity_bytes + 1e-6, (
            f"pool {self.name!r} oversubscribed: "
            f"{self.used_bytes} > {self.capacity_bytes}"
        )
        assert self.scratch_bytes >= -1e-6
        if self.state is PoolState.RETIRED:
            assert not self.leases, f"retired pool {self.name!r} has live leases"
