"""Persistent storage pools with a data-aware catalog.

The paper provisions a job-scoped BeeGFS instance and tears it down at job
end; DataWarp's persistent-instance mode — and Data Diffusion's data-aware
scheduling over cached provisioned storage — motivate the opposite design:
long-lived pools that outlive single jobs, sub-allocated through leases,
with a catalog tracking which datasets are already resident where so the
orchestrator can route jobs to their data and skip stage-in on cache hits.

Modules: `catalog` (DatasetRef + residency index), `pool` (capacity ledger +
leases), `eviction` (LRU engine under pressure), `manager` (PoolManager, the
only mutator). `DataAwarePolicy` lives with its siblings in
``repro.orchestrator.policies``.
"""

from .catalog import DataCatalog, DatasetRef, Residency, ResidencyState, total_bytes
from .eviction import EvictionPolicy, Evictor, LRUEviction
from .manager import PoolManager, PoolStats
from .pool import (
    Lease,
    PoolCapacityError,
    PoolError,
    PoolState,
    StoragePool,
)

__all__ = [
    "DataCatalog", "DatasetRef", "Residency", "ResidencyState", "total_bytes",
    "EvictionPolicy", "Evictor", "LRUEviction",
    "PoolManager", "PoolStats",
    "Lease", "PoolCapacityError", "PoolError", "PoolState", "StoragePool",
]
