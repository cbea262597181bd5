"""StorageSession: one negotiated grant of storage, whatever the backend.

The session is the *only* lifecycle handle callers hold. Whether the
negotiation landed on a job-scoped ephemeral file system (allocation +
deploy + teardown), a lease on a persistent pool (attach + drain), the
always-on global file system (nothing to deploy), or a KV store, the caller
sees the same surface:

    with service.open_session(spec) as sess:
        sess.mount()          # functional client (materialized sessions)
        sess.stage_in_time_s  # modeled staging cost (campaign engines)
        ...
    # exit -> release(): teardown vs lease-drain vs no-op is *policy here*,
    # not caller code; nodes/leases are returned even on exception.

Modeled fields (`provision_time_s`, `teardown_time_s`, `stage_in_bytes`,
`saved_bytes`, `fs_model`) are what the workflow orchestrator advances its
virtual clock by; functional fields (`deployment`, `kv`) exist only for
``materialize=True`` sessions that move real bytes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Optional

from ..core.perfmodel import FSDeployment
from ..core.scheduler import Allocation
from ..core.staging import modeled_stage_time
from .spec import LifetimeClass, StorageSpec

if TYPE_CHECKING:
    from ..core.kvstore import EphemeralKV
    from ..core.provisioner import Deployment
    from ..pool.pool import Lease, StoragePool
    from .negotiation import Offer
    from .service import ProvisioningService


class SessionState(enum.Enum):
    OPEN = "open"
    RELEASED = "released"


class SessionError(RuntimeError):
    pass


def _model_key(model: FSDeployment) -> tuple:
    """The fields :func:`modeled_stage_time` actually reads — a stable cache
    key even when deployments are distinct (but equal-shaped) instances.
    ``mdtest_table`` is deliberately excluded: staging never consults it
    (and it may be an unhashable dict). Memoized on the (frozen) model —
    deployment models are canonicalized and long-lived."""
    try:
        return model._stage_key_cache
    except AttributeError:
        pass
    key = (
        model.kind,
        model.n_nodes,
        model.storage_targets,
        model.md_targets,
        model.disk,
        model.node_dram,
        model.net,
        model.local_client,
    )
    object.__setattr__(model, "_stage_key_cache", key)
    return key


@dataclasses.dataclass(slots=True)
class StorageSession:
    """A live negotiated grant; mutated only by itself and its service."""

    spec: StorageSpec
    offer: "Offer"
    service: "ProvisioningService"
    opened_at: float
    allocation: Optional[Allocation] = None      # nodes this session pins
    lease: Optional["Lease"] = None              # POOLED capacity grant
    pool: Optional["StoragePool"] = None         # PERSISTENT creation handle
    fs_model: Optional[FSDeployment] = None      # perfmodel view for staging
    provision_time_s: float = 0.0                # modeled attach/deploy
    teardown_time_s: float = 0.0                 # modeled release cost
    stage_in_bytes: float = 0.0                  # bytes stage-in must move
    stage_out_bytes: float = 0.0
    saved_bytes: float = 0.0                     # stage-in avoided (hits etc.)
    deployment: Optional["Deployment"] = None    # materialized ephemeral FS
    kv: Optional["EphemeralKV"] = None           # materialized KV store
    state: SessionState = SessionState.OPEN
    #: effective redundancy of the granted deployment: "mirror" when the
    #: backend honors the spec's mirror hint (BeeGFS buddy groups), else
    #: "none" — the chaos engine's survive-or-die switch on node loss
    redundancy: str = "none"
    #: True once a mirrored deployment lost a node: it keeps serving at
    #: halved effective bandwidth (every modeled staging/checkpoint time
    #: doubles) until the session ends — repairs re-silver offline
    degraded: bool = False

    # -- introspection --------------------------------------------------------
    @property
    def backend(self) -> str:
        return self.offer.backend

    @property
    def lifetime(self) -> LifetimeClass:
        return self.spec.lifetime

    @property
    def storage_nodes(self) -> tuple:
        if self.pool is not None:
            return self.pool.allocation.storage_nodes
        if self.allocation is not None:
            return self.allocation.storage_nodes
        return ()

    @property
    def released(self) -> bool:
        return self.state is SessionState.RELEASED

    # -- failure domain (chaos engine) ----------------------------------------
    @property
    def can_degrade(self) -> bool:
        """Would this session survive a single storage-node loss? Mirrored
        deployments spanning >= 2 nodes degrade; everything else dies."""
        return (
            self.redundancy == "mirror"
            and not self.degraded
            and len(self.storage_nodes) >= 2
        )

    def degrade(self) -> None:
        """Enter DEGRADED mode after a node loss: the surviving mirror half
        serves every read/write, so effective bandwidth halves (modeled as
        doubled staging/checkpoint times). A second loss is fatal — the
        caller checks :attr:`can_degrade` first."""
        self._check_open()
        if not self.can_degrade:
            raise SessionError(
                f"session {self.spec.name!r} has no redundancy left to degrade"
            )
        self.degraded = True

    # -- modeled staging (virtual-clock engines) ------------------------------
    def _staging_time(
        self,
        nbytes: float,
        src: Optional[FSDeployment],
        dst: Optional[FSDeployment],
    ) -> float:
        """Memoized :func:`modeled_stage_time` via the service: a campaign
        stages the same byte counts through the same deployment shapes
        thousands of times. A ``None`` endpoint skips that side of the
        model (e.g. checkpoint bursts, whose source is compute memory)."""
        cache = self.service._stage_time_cache
        key = (
            nbytes,
            self.spec.n_streams,
            None if src is None else _model_key(src),
            None if dst is None else _model_key(dst),
        )
        t = cache.get(key)
        if t is None:
            t = modeled_stage_time(nbytes, src, dst, self.spec.n_streams)
            cache[key] = t
        # degraded mirror: the surviving half serves everything — halved
        # effective bandwidth, applied *after* the cache so healthy sessions
        # of the same shape keep sharing the memoized base time
        if self.degraded:
            return t * 2.0
        return t

    @property
    def stage_in_time_s(self) -> float:
        """Modeled wall time for stage-in: global FS read feeding this
        session's data manager (for a globalfs-backed session both ends are
        the global FS — the data never leaves it)."""
        if self.stage_in_bytes <= 0 or self.fs_model is None:
            return 0.0
        return self._staging_time(
            self.stage_in_bytes, self.service.globalfs_model, self.fs_model
        )

    @property
    def stage_out_time_s(self) -> float:
        if self.stage_out_bytes <= 0 or self.fs_model is None:
            return 0.0
        return self._staging_time(
            self.stage_out_bytes, self.fs_model, self.service.globalfs_model
        )

    def stage_time_s(self, nbytes: float, direction: str = "in") -> float:
        """Modeled wall time to move ``nbytes`` through this session in one
        aggregate transfer (``"in"``: global FS feeding the data manager;
        ``"out"``: the reverse). This is the batch-pricing surface for pilot
        task waves — one call prices a whole wave's coalesced I/O through
        the memoized, degraded-aware perfmodel path instead of one model
        walk per task. Zero for storage-less sessions."""
        if nbytes <= 0 or self.fs_model is None:
            return 0.0
        if direction == "in":
            return self._staging_time(
                nbytes, self.service.globalfs_model, self.fs_model
            )
        if direction == "out":
            return self._staging_time(
                nbytes, self.fs_model, self.service.globalfs_model
            )
        raise ValueError(f"direction must be 'in' or 'out', got {direction!r}")

    def checkpoint_write_s(self, nbytes: float) -> float:
        """Modeled wall time for one checkpoint commit: the compute side
        bursts ``nbytes`` into this session's data manager, so the cost is
        the destination write path alone (charged against the session's
        bandwidth via the perfmodel — `repro.checkpoint`'s burst-then-drain
        story priced for the virtual clock). Zero for storage-less sessions."""
        if nbytes <= 0 or self.fs_model is None:
            return 0.0
        return self._staging_time(nbytes, None, self.fs_model)

    def mark_staged(self, now: Optional[float] = None) -> None:
        """Stage-in finished: publish lease datasets as RESIDENT (cache hits
        for every later session routed to the same pool). No-op otherwise."""
        if self.lease is not None:
            self.service.pool_manager.on_stage_in_complete(self.lease, now)

    # -- functional access (materialized sessions) -----------------------------
    def mount(self, client_id: str = "client0"):
        """An I/O client: `FSClient` for POSIX backends, the KV store itself
        for ``access="kv"``. Requires ``materialize=True`` at open (except
        globalfs, which is always live)."""
        self._check_open()
        if self.kv is not None:
            return self.kv
        if self.deployment is not None:
            return self.deployment.mount(client_id)
        fs = self.service.materialized_globalfs()
        if self.backend == "globalfs" and fs is not None:
            from ..core.client import FSClient

            return FSClient(fs, client_id)
        raise SessionError(
            f"session {self.spec.name!r} is modeled-only; "
            "open with materialize=True for functional I/O"
        )

    # -- lifecycle -------------------------------------------------------------
    def _check_open(self) -> None:
        if self.state is not SessionState.OPEN:
            raise SessionError(f"session {self.spec.name!r} is {self.state.value}")

    def release(self, now: Optional[float] = None) -> None:
        """Return everything this session holds. Idempotent; safe mid-fault.

        Teardown-vs-drain is internal policy: EPHEMERAL sessions tear down
        their data manager and free their nodes; POOLED sessions drop the
        lease (the pool outlives them; a DRAINING pool's last lease tears it
        down via the PoolManager); PERSISTENT sessions release only the
        handle — the pool they created keeps running until :meth:`retire`
        or the manager's idle TTL.
        """
        if self.state is SessionState.RELEASED:
            return
        self.state = SessionState.RELEASED
        if self.lease is not None:
            self.service.pool_manager.release(self.lease, now)
            self.lease = None
        if self.deployment is not None:
            self.deployment.teardown()
            self.deployment = None
        if self.kv is not None:
            self.kv.teardown()
            self.service.provisioner.release_tree(self.kv.base_dir)
            self.kv = None
        if self.allocation is not None:
            self.service.scheduler.release(self.allocation)
            self.allocation = None
        self.service.stats.sessions_released += 1
        rec = self.service.recorder
        if rec.enabled:
            rec.session_released(self.backend)

    def retire(self, now: Optional[float] = None) -> bool:
        """PERSISTENT only: stop granting leases on the created pool and tear
        it down once drained. Returns True if torn down immediately."""
        if self.pool is None:
            raise SessionError(
                f"session {self.spec.name!r} did not create a pool; "
                "only PERSISTENT sessions retire"
            )
        return self.service.pool_manager.retire(self.pool, now)

    def __enter__(self) -> "StorageSession":
        self._check_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()
