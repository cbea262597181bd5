"""Unified StorageSession API: declarative specs, backend negotiation.

The public provisioning surface of the repo (the mandated entry point for
new code — see ROADMAP):

    StorageSpec  ->  ProvisioningService.open_session()  ->  StorageSession

`StorageSpec` declares sizing (capacity | bandwidth | node count), preferred
data managers with ordered fallbacks, a lifetime class (EPHEMERAL per-job /
POOLED lease / PERSISTENT pool-create), datasets to stage, placement hints,
and QoS. The service negotiates capabilities across the `BackendRegistry`
(ephemeralfs, globalfs, kvstore, null by default), grants the best feasible
backend or raises `NegotiationError` with per-backend rejection reasons, and
hands back a `StorageSession` context manager that unifies the lifecycle —
teardown vs lease-drain vs pool persistence is session policy, not caller
code. `Scheduler`/`Provisioner`/`PoolManager` remain the internal engine.
"""

from .backends import (
    BackendCapabilities,
    BackendRegistry,
    DataManagerBackend,
    EphemeralFSBackend,
    GlobalFSBackend,
    KVStoreBackend,
    NullBackend,
    default_registry,
)
from .negotiation import NegotiationError, Offer, Rejection
from .service import ProvisioningService, ServiceStats
from .session import SessionError, SessionState, StorageSession
from .spec import LifetimeClass, Placement, QoS, StorageSpec

__all__ = [
    "BackendCapabilities", "BackendRegistry", "DataManagerBackend",
    "EphemeralFSBackend", "GlobalFSBackend", "KVStoreBackend", "NullBackend",
    "default_registry",
    "NegotiationError", "Offer", "Rejection",
    "ProvisioningService", "ServiceStats",
    "SessionError", "SessionState", "StorageSession",
    "LifetimeClass", "Placement", "QoS", "StorageSpec",
]
