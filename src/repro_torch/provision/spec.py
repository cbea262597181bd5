"""StorageSpec: one declarative request for provisioned storage.

The paper's workflow vision (§VII) is that a job "should be able to select
both its preferred data manager and its required storage capability or
capacity". PR 1-2 left three hand-wired paths to that end (Scheduler.submit +
Provisioner.deploy, PoolManager leases, orchestrator internals); this module
is the single request type they all collapse behind:

* **sizing** — exactly one of ``nodes`` / ``capacity_bytes`` / ``bandwidth``
  (the paper's §V quantity-vs-speed trade-off, now with bandwidth as a
  first-class axis);
* **preferred data managers** — ordered backend names with fallbacks
  (``managers=("kvstore", "ephemeralfs")``), or empty for "any registered";
* **lifetime class** — `EPHEMERAL` (job-scoped deploy + teardown), `POOLED`
  (lease on a live persistent pool), `PERSISTENT` (create a pool);
* **datasets** — shared inputs to stage (`DatasetRef`), plus private
  stage-in/out traffic;
* **placement** — striping / mirroring hints;
* **QoS** — minimum aggregate bandwidth and maximum provisioning latency,
  validated against the perfmodel during negotiation.

A spec never names cluster nodes or pool ids: the `ProvisioningService`
negotiates those (see ``negotiation``), so the same spec is portable across
backends and clusters.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Literal, Optional

from ..core.scheduler import StorageRequest
from ..core.striping import DEFAULT_STRIPE
from ..pool.catalog import DatasetRef, total_bytes


class LifetimeClass(enum.Enum):
    EPHEMERAL = "ephemeral"      # job-scoped: deploy, use, tear down
    POOLED = "pooled"            # lease capacity on a live persistent pool
    PERSISTENT = "persistent"    # create a pool that outlives the session


@dataclasses.dataclass(frozen=True)
class QoS:
    """Service-level floor/ceiling the negotiated backend must honor."""

    min_bandwidth: Optional[float] = None        # aggregate write B/s floor
    max_provision_s: Optional[float] = None      # modeled attach/deploy ceiling

    def __post_init__(self) -> None:
        if self.min_bandwidth is not None and self.min_bandwidth <= 0:
            raise ValueError("min_bandwidth must be positive")
        if self.max_provision_s is not None and self.max_provision_s < 0:
            raise ValueError("max_provision_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Striping / redundancy hints, honored when the backend supports them."""

    stripe_size: int = DEFAULT_STRIPE
    mirror: bool = False

    def __post_init__(self) -> None:
        if self.stripe_size <= 0:
            raise ValueError("stripe_size must be positive")


Access = Literal["posix", "kv"]


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """A declarative storage request; negotiated, never hand-placed."""

    name: str
    nodes: Optional[int] = None
    capacity_bytes: Optional[float] = None
    bandwidth: Optional[float] = None            # aggregate write B/s sizing
    managers: tuple[str, ...] = ()               # ordered preference; () = any
    lifetime: LifetimeClass = LifetimeClass.EPHEMERAL
    access: Access = "posix"
    datasets: tuple[DatasetRef, ...] = ()        # shared inputs to stage
    stage_in_bytes: float = 0.0                  # private stage-in traffic
    stage_out_bytes: float = 0.0                 # private stage-out traffic
    n_streams: int = 8
    placement: Placement = Placement()
    qos: QoS = QoS()
    runtime: Literal["shifter", "docker"] = "shifter"
    capacity_cap_bytes: Optional[float] = None   # PERSISTENT: ledger quota

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("spec name must be non-empty")
        object.__setattr__(self, "managers", tuple(self.managers))
        object.__setattr__(self, "datasets", tuple(self.datasets))
        n_sizing = sum(
            x is not None for x in (self.nodes, self.capacity_bytes, self.bandwidth)
        )
        if self.lifetime is LifetimeClass.POOLED:
            if n_sizing:
                raise ValueError(
                    f"{self.name!r}: POOLED specs are sized by datasets + "
                    "stage bytes (the lease), not nodes/capacity/bandwidth"
                )
        elif n_sizing > 1:
            raise ValueError(
                f"{self.name!r}: set at most one of nodes/capacity_bytes/"
                "bandwidth (unsized specs negotiate onto backends that need "
                "no dedicated nodes, e.g. globalfs/null)"
            )
        elif n_sizing == 0 and self.lifetime is LifetimeClass.PERSISTENT:
            raise ValueError(
                f"{self.name!r}: PERSISTENT specs must size the pool "
                "(nodes, capacity_bytes, or bandwidth)"
            )
        if self.nodes is not None and self.nodes <= 0:
            raise ValueError(f"{self.name!r}: nodes must be positive")
        if self.capacity_bytes is not None and self.capacity_bytes <= 0:
            raise ValueError(f"{self.name!r}: capacity_bytes must be positive")
        if self.bandwidth is not None and self.bandwidth <= 0:
            raise ValueError(f"{self.name!r}: bandwidth must be positive")
        if self.stage_in_bytes < 0 or self.stage_out_bytes < 0:
            raise ValueError(f"{self.name!r}: negative stage bytes")
        if self.n_streams <= 0:
            raise ValueError(f"{self.name!r}: n_streams must be positive")
        if self.capacity_cap_bytes is not None and self.capacity_cap_bytes <= 0:
            raise ValueError(f"{self.name!r}: capacity_cap_bytes must be positive")
        if any(not isinstance(d, DatasetRef) for d in self.datasets):
            raise ValueError(f"{self.name!r}: datasets must be DatasetRef instances")
        if len({d.name for d in self.datasets}) != len(self.datasets):
            raise ValueError(f"{self.name!r}: duplicate dataset names")
        if any(not m for m in self.managers):
            raise ValueError(f"{self.name!r}: empty backend name in managers")

    # -- derived views --------------------------------------------------------
    def signature(self) -> tuple:
        """Hashable identity of everything negotiation and admission can
        observe about this spec — every field except the name. Two specs
        with equal signatures receive identical offers from ``negotiate``
        and identical grant/deny answers from every backend at any given
        cluster/pool state, which is what the negotiation cache and the
        dispatch queue's admission buckets key on. (The one name-sensitive
        path, PERSISTENT create-or-reattach, is handled by the callers:
        they append the name for that lifetime.)

        Memoized on the (frozen) instance: negotiation and dispatch consult
        it on every admission attempt."""
        try:
            return self._signature_cache
        except AttributeError:
            pass
        sig = (
            self.nodes,
            self.capacity_bytes,
            self.bandwidth,
            self.managers,
            self.lifetime,
            self.access,
            self.datasets,
            self.stage_in_bytes,
            self.stage_out_bytes,
            self.n_streams,
            self.placement,
            self.qos,
            self.runtime,
            self.capacity_cap_bytes,
        )
        object.__setattr__(self, "_signature_cache", sig)
        return sig

    @property
    def dataset_bytes(self) -> float:
        return total_bytes(self.datasets)

    @property
    def scratch_bytes(self) -> float:
        """Private capacity a lease reserves on top of shared datasets."""
        return self.stage_in_bytes + self.stage_out_bytes

    def to_request(self) -> Optional[StorageRequest]:
        """The scheduler-level sizing request (None for POOLED specs, which
        draw capacity from a lease, and for unsized specs, which negotiate
        onto backends that grant no dedicated nodes). Memoized on the
        (frozen) instance — admission paths build it per attempt."""
        try:
            return self._to_request_cache
        except AttributeError:
            pass
        if self.lifetime is LifetimeClass.POOLED or (
            self.nodes is None
            and self.capacity_bytes is None
            and self.bandwidth is None
        ):
            req = None
        else:
            req = StorageRequest(
                nodes=self.nodes,
                capacity_bytes=self.capacity_bytes,
                capability_bw=self.bandwidth,
            )
        object.__setattr__(self, "_to_request_cache", req)
        return req
