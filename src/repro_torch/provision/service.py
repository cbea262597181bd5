"""ProvisioningService: the single entry point for provisioned storage.

    spec = StorageSpec("job0", capacity_bytes=10e12,
                       managers=("ephemeralfs", "globalfs"))
    with service.open_session(spec) as session:
        ...

The service owns the negotiation loop (spec -> scored backends -> session)
and wires the engine parts underneath — `Scheduler` (node allocation),
`Provisioner` (deployment planning/warm trees), and a lazily-created
`PoolManager` (persistent pools + data-aware catalog). Those remain the
internal engine; callers that used to hand-wire them (examples, benchmarks,
the workflow orchestrator's lifecycle) go through here instead, which is
also the mandated substrate for future scaling/serving PRs (ROADMAP).

Two opening paths:

* :meth:`open_session` — the facade path; raises when the cluster is busy
  (callers that queue should use the orchestrator, which does the retrying).
* :meth:`try_open_session` — the queueing-scheduler path; returns ``None``
  when the spec is feasible but does not fit the free pool *right now*, and
  raises :class:`NegotiationError` only for specs no backend can ever serve.

The service also keeps negotiation telemetry (`ServiceStats`): counts, per-
backend session tallies, and cumulative negotiation wallclock, which
``benchmarks/provision_bench.py`` holds under 5% of campaign makespan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from ..core.perfmodel import FSDeployment, dom_lustre
from ..core.provisioner import Provisioner
from ..core.resources import ClusterSpec
from ..core.scheduler import AllocationError, Scheduler
from ..obs.trace import NULL_RECORDER
from ..pool.catalog import DatasetRef
from ..pool.manager import PoolManager
from .backends import BackendRegistry, default_registry
from .negotiation import NegotiationError, Offer, OfferCache, negotiate
from .session import StorageSession
from .spec import LifetimeClass, StorageSpec


@dataclasses.dataclass
class ServiceStats:
    """Negotiation + session telemetry for benchmarks and reports."""

    negotiations: int = 0
    negotiation_wall_s: float = 0.0        # cumulative wallclock inside negotiate()
    negotiations_cached: int = 0           # of which served from the offer cache
    failed_negotiations: int = 0
    sessions_opened: dict = dataclasses.field(default_factory=dict)  # backend -> n
    sessions_released: int = 0

    def record_open(self, backend: str) -> None:
        self.sessions_opened[backend] = self.sessions_opened.get(backend, 0) + 1

    @property
    def total_opened(self) -> int:
        return sum(self.sessions_opened.values())


class ProvisioningService:
    """Declarative request -> negotiated `StorageSession`, one entry point."""

    def __init__(
        self,
        cluster: Optional[ClusterSpec] = None,
        *,
        scheduler: Optional[Scheduler] = None,
        provisioner: Optional[Provisioner] = None,
        registry: Optional[BackendRegistry] = None,
        globalfs_model: Optional[FSDeployment] = None,
        teardown_time_s: float = 0.5,
        clock: Optional[Callable[[], float]] = None,
    ):
        if scheduler is None:
            if cluster is None:
                raise ValueError("pass a ClusterSpec or an existing Scheduler")
            scheduler = Scheduler(cluster)
        self.scheduler = scheduler
        self.cluster = scheduler.cluster
        self.provisioner = provisioner or Provisioner(self.cluster)
        self.registry = registry or default_registry()
        self.globalfs_model = globalfs_model or dom_lustre()
        self.teardown_time_s = teardown_time_s
        self.clock = clock
        self.pool_manager: Optional[PoolManager] = None
        self._pool_kwargs: dict = {}
        self.stats = ServiceStats()
        self._globalfs = None          # lazily materialized functional GlobalFS
        self._offer_cache = OfferCache()
        self._pool_gen = 0             # bumped when the pool subsystem is replaced
        # modeled stage times repeat across same-shape sessions; keyed by
        # (direction, bytes, streams, src-shape, dst-shape) — see session.py
        self._stage_time_cache: dict[tuple, float] = {}
        self._recorder = NULL_RECORDER

    # -- observability ---------------------------------------------------------
    @property
    def recorder(self):
        """The trace recorder negotiation/session events flow into (a
        no-op by default). Assigning propagates to the scheduler and the
        pool subsystem, including managers created later."""
        return self._recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        self._recorder = rec
        self.scheduler.recorder = rec
        if self.pool_manager is not None:
            self.pool_manager.recorder = rec

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        return self.clock() if self.clock is not None else 0.0

    # -- pools (lazy engine part) ---------------------------------------------
    def ensure_pools(self, **kwargs) -> PoolManager:
        """The pool subsystem behind POOLED/PERSISTENT specs; created on
        first use (or eagerly, to set TTL/eviction/attach-cost knobs).
        Reconfiguring (passing kwargs) replaces the manager, which is only
        legal while it holds no live pools — replacing it later would orphan
        their node allocations and claimed trees."""
        if self.pool_manager is not None:
            if not kwargs:
                return self.pool_manager
            if self.pool_manager.live_pools:
                raise ValueError(
                    "cannot reconfigure the pool subsystem while "
                    f"{len(self.pool_manager.live_pools)} pools are live; "
                    "retire them first"
                )
        kwargs.setdefault("clock", self.clock)
        self.pool_manager = PoolManager(self.scheduler, self.provisioner, **kwargs)
        self.pool_manager.recorder = self._recorder
        # a fresh manager restarts its epoch at 0; the generation counter
        # keeps POOLED offers cached against the old manager from matching
        self._pool_gen += 1
        return self.pool_manager

    def resident_fraction(self, datasets: Sequence[DatasetRef]) -> float:
        """Best-pool resident-byte fraction (0.0 without pools) — the ranking
        signal `DataAwarePolicy` consumes, now service-level so policies do
        not reach into the PoolManager."""
        if self.pool_manager is None:
            return 0.0
        return self.pool_manager.resident_fraction(datasets)

    # -- negotiation -----------------------------------------------------------
    def _negotiation_epoch(self, spec: StorageSpec) -> tuple:
        """Everything a cached offer for ``spec`` can go stale against.
        EPHEMERAL/PERSISTENT offers are scored against the static inventory,
        so only backend registrations invalidate them; POOLED offers track
        the pool subsystem (manager generation + PoolManager epoch, which
        folds in lease-ledger and catalog changes)."""
        if spec.lifetime is LifetimeClass.POOLED:
            pm = self.pool_manager
            pool_state = (self._pool_gen, pm.epoch if pm is not None else -1)
        else:
            pool_state = ()
        return (self.registry.version, pool_state)

    def negotiate(self, spec: StorageSpec) -> Offer:
        """Score candidate backends, return the best feasible offer, or raise
        :class:`NegotiationError` with per-backend rejection reasons.
        Memoized by spec signature + state epoch (see `OfferCache`), so a
        campaign re-scores a spec shape only when the state it negotiated
        against actually changed. ``negotiation_wall_s`` accounts the real
        scoring work; cache hits cost (and add) effectively nothing."""
        stats = self.stats
        stats.negotiations += 1
        sig = spec.signature()
        epoch = self._negotiation_epoch(spec)
        cache = self._offer_cache
        rec = self._recorder
        result = cache.lookup(sig, epoch)
        if result is not None:
            # increment, never assign from cache.hits: the cache object can
            # be swapped/reset mid-campaign while the stats must keep
            # accumulating (tests/test_provision_api.py pins this)
            stats.negotiations_cached += 1
            if rec.enabled:
                rec.negotiation(spec.name, None, cached=True)
            if isinstance(result, Offer):
                return result
            stats.failed_negotiations += 1
            raise NegotiationError(spec.name, result)
        t0 = time.perf_counter()
        try:
            offer = negotiate(spec, self, self.registry)
        except NegotiationError as e:
            cache.store(sig, epoch, e.rejections)
            stats.failed_negotiations += 1
            if rec.enabled:
                rec.negotiation(spec.name, None, cached=False, rejections=e.rejections)
            raise
        finally:
            stats.negotiation_wall_s += time.perf_counter() - t0
        cache.store(sig, epoch, offer)
        if rec.enabled:
            rec.negotiation(
                spec.name, offer.backend, cached=False, rejections=offer.rejections
            )
        return offer

    def feasible(self, spec: StorageSpec, *, n_compute: int = 0) -> bool:
        """Could some backend ever serve this spec (empty cluster)?"""
        if n_compute > len(self.cluster.compute_nodes):
            return False
        try:
            self.negotiate(spec)
        except NegotiationError:
            return False
        return True

    # -- sessions --------------------------------------------------------------
    def try_open_session(
        self,
        spec: StorageSpec,
        *,
        n_compute: int = 0,
        warm_nodes: frozenset = frozenset(),
        materialize: bool = False,
        base_dir: Optional[str] = None,
        now: Optional[float] = None,
        offer: Optional[Offer] = None,
        staged_nodes: frozenset = frozenset(),
        restore_bytes: float = 0.0,
        restore_pool_id: Optional[int] = None,
    ) -> Optional[StorageSession]:
        """Negotiate and grant, or ``None`` when the cluster is merely busy.

        ``n_compute`` co-allocates compute nodes in the same scheduler grant
        (the paper's two-allocations-one-path mechanism), so a session never
        holds storage while its job's compute can't start. ``warm_nodes``
        lets retrying callers model the §IV-B1 warm redeploy. Queueing
        callers retrying the same spec may pass back a prior ``offer`` to
        skip re-negotiation — safe only while the feasibility landscape is
        static (i.e. never cache offers for POOLED specs, whose candidate
        pools retire and drain mid-campaign).

        Checkpoint-resuming callers size stage-in with ``staged_nodes``
        (storage nodes still holding the fully staged inputs of an earlier
        attempt: a grant landing entirely on them skips stage-in) and
        ``restore_bytes`` (checkpoint state read back from the global FS on
        a cold landing); POOLED resumes additionally pass
        ``restore_pool_id`` so a lease landing back on the checkpoint's own
        pool skips the restore read (residency) — admission answers are
        unchanged, only modeled staging costs move (see
        :meth:`DataManagerBackend.try_open`).
        """
        now = self._now(now)
        if offer is None:
            offer = self.negotiate(spec)    # raises NegotiationError if hopeless
        backend = self.registry.get(offer.backend)
        session = backend.try_open(
            spec,
            offer,
            self,
            n_compute=n_compute,
            warm_nodes=warm_nodes,
            materialize=materialize,
            base_dir=base_dir,
            now=now,
            staged_nodes=staged_nodes,
            restore_bytes=restore_bytes,
            restore_pool_id=restore_pool_id,
        )
        if session is not None:
            self.stats.record_open(offer.backend)
            rec = self._recorder
            if rec.enabled:
                rec.session_opened(offer.backend)
        return session

    def open_session(
        self,
        spec: StorageSpec,
        *,
        n_compute: int = 0,
        materialize: bool = False,
        base_dir: Optional[str] = None,
        now: Optional[float] = None,
    ) -> StorageSession:
        """The facade path: grant now or raise (busy clusters raise too —
        queueing callers should drive :meth:`try_open_session` instead)."""
        session = self.try_open_session(
            spec,
            n_compute=n_compute,
            materialize=materialize,
            base_dir=base_dir,
            now=now,
        )
        if session is None:
            free_c, free_s = self.scheduler.free_counts()
            raise AllocationError(
                f"{spec.name!r}: negotiated backend cannot grant now "
                f"(free: {free_c} compute / {free_s} storage nodes); "
                "use try_open_session / the orchestrator to queue"
            )
        return session

    # -- functional global FS (quickstarts) ------------------------------------
    def materialized_globalfs(self, create: bool = False):
        """The shared functional `GlobalFS` instance for materialized
        globalfs-backed sessions (created on demand, shared by design)."""
        if self._globalfs is None and create:
            from ..core.globalfs import GlobalFS

            self._globalfs = GlobalFS()
        return self._globalfs
