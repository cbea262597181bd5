"""DataManager backends: declared capabilities + session construction.

Each backend wraps one of the repo's data managers behind a uniform
negotiation surface (the paper's §VII pitch that the provisioning mechanism
is generic over "parallel file system, object-based storage, database,
key-value store"):

* ``ephemeralfs`` — the BeeGFS-analogue; POSIX, striping + mirroring,
  dedicated storage nodes, supports every lifetime class (job-scoped
  deploy, pool leases, pool creation). Pays the C8 deploy cost.
* ``globalfs``   — the always-on Lustre-analogue; POSIX, zero provisioning
  latency, but no dedicated nodes, fixed aggregate bandwidth shared with
  the rest of the machine, and datasets already live there (nothing to
  stage).
* ``kvstore``    — hash-partitioned KV on dedicated nodes; ``access="kv"``
  only, replication via the mirror placement hint, job-scoped lifetime.
* ``null``       — a dry-run backend that accepts any spec at zero cost;
  must be requested by name, so it never wins a real negotiation. The
  orchestrator uses it for jobs with no storage demand, and tests use it
  to exercise the session lifecycle without touching the cluster.

``check`` answers *could this backend ever serve the spec* (capability,
sizing vs whole-cluster inventory, QoS vs perfmodel) with a structured
rejection reason; ``try_open`` performs the actual grant against the free
pool and returns ``None`` when the cluster is merely busy.
"""

from __future__ import annotations

import abc
import dataclasses
import tempfile
from typing import TYPE_CHECKING, Iterator, Optional

from ..core.perfmodel import predict_deploy_time
from ..core.scheduler import AllocationError, JobRequest
from .negotiation import Offer
from .session import StorageSession
from .spec import LifetimeClass, StorageSpec

if TYPE_CHECKING:
    from .service import ProvisioningService


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a data manager can do, declared once at registration."""

    access: tuple[str, ...]                  # ("posix",) / ("kv",) / both
    lifetimes: frozenset                     # supported LifetimeClass values
    striping: bool = False                   # honors stripe_size hints
    mirroring: bool = False                  # honors the mirror hint
    dedicated_nodes: bool = False            # grants allocate storage nodes
    persistent_data: bool = False            # data survives the session
    zero_deploy: bool = False                # no provisioning latency
    #: redundancy classes the manager can deploy: "none" always; "mirror"
    #: (BeeGFS buddy groups / KV replication) lets a multi-node deployment
    #: survive a single storage-node loss in DEGRADED mode instead of dying
    redundancy: tuple[str, ...] = ("none",)


class DataManagerBackend(abc.ABC):
    """One registered data manager the service can negotiate onto."""

    name: str = "abstract"
    capabilities: BackendCapabilities
    #: True when, for EPHEMERAL specs, ``try_open`` returns None *iff* the
    #: scheduler co-allocation (n_compute, plus the resolved storage demand
    #: when ``capabilities.dedicated_nodes``) does not fit the free pool —
    #: i.e. admission is gated by the scheduler alone. Lets dispatchers
    #: pre-filter hopeless probes with two O(1) count checks. Custom
    #: backends with extra admission conditions must leave this False.
    scheduler_gated: bool = False

    # -- negotiation -----------------------------------------------------------
    def check(self, spec: StorageSpec, svc: "ProvisioningService") -> Optional[str]:
        """Rejection reason, or None when the spec is serveable (ever)."""
        caps = self.capabilities
        if spec.access not in caps.access:
            return f"no {spec.access} access (offers {'/'.join(caps.access)})"
        if spec.lifetime not in caps.lifetimes:
            return f"does not support {spec.lifetime.value} lifetime"
        if spec.placement.mirror and not caps.mirroring:
            return "no mirroring support"
        return self._check(spec, svc)

    @abc.abstractmethod
    def _check(self, spec: StorageSpec, svc: "ProvisioningService") -> Optional[str]:
        ...

    @abc.abstractmethod
    def offer(self, spec: StorageSpec, svc: "ProvisioningService") -> Offer:
        """Feasible terms for a spec that passed :meth:`check`. Score favors
        QoS headroom, then low provisioning latency, then few nodes."""

    # -- session construction --------------------------------------------------
    @abc.abstractmethod
    def try_open(
        self,
        spec: StorageSpec,
        offer: Offer,
        svc: "ProvisioningService",
        *,
        n_compute: int = 0,
        warm_nodes: frozenset = frozenset(),
        materialize: bool = False,
        base_dir: Optional[str] = None,
        now: float = 0.0,
        staged_nodes: frozenset = frozenset(),
        restore_bytes: float = 0.0,
        restore_pool_id: Optional[int] = None,
    ) -> Optional[StorageSession]:
        """Grant against the free pool; None when merely busy right now.

        Resume-aware sizing (checkpoint-restarting callers): ``staged_nodes``
        are storage nodes already holding this spec's *fully staged* input
        set from a completed earlier attempt — a grant landing entirely on
        them skips stage-in (the data, checkpoints included, is still in the
        warm tree; the skipped traffic is reported as ``saved_bytes``).
        ``restore_bytes`` is checkpoint state to read back from the global
        FS on a cold landing; it joins the stage-in bill. For POOLED specs,
        ``restore_pool_id`` names the pool the checkpoint was committed into
        — a lease landing on that exact pool (ids are never reused) finds
        the checkpoint still RESIDENT in the warm tree and skips the restore
        read entirely. None of these affect *admission* (grant/deny), only
        the session's modeled staging costs, so same-signature jobs stay
        interchangeable to dispatch buckets."""

    @staticmethod
    def _score(bandwidth: float, spec: StorageSpec, provision_s: float, n_nodes: int) -> float:
        floor = spec.qos.min_bandwidth
        headroom = min(bandwidth / floor, 4.0) if floor else bandwidth / 1e9
        return headroom - 0.1 * provision_s - 0.01 * n_nodes


def _effective_redundancy(
    spec: StorageSpec, caps: BackendCapabilities, n_nodes: int
) -> str:
    """The redundancy class a grant actually deploys with: "mirror" only
    when the spec asked for it, the backend can do it, and there are at
    least two nodes to mirror across — otherwise "none"."""
    if spec.placement.mirror and "mirror" in caps.redundancy and n_nodes >= 2:
        return "mirror"
    return "none"


def _resume_stage_in(
    spec: StorageSpec,
    granted_ids: frozenset,
    staged_nodes: frozenset,
    restore_bytes: float,
) -> tuple[float, float]:
    """(stage_in_bytes, saved_bytes) for a dedicated-node grant under the
    resume model: landing entirely on nodes that still hold the staged data
    (warm trees, §IV-B1 extended to data) skips the whole stage-in; a cold
    landing replays it plus the checkpoint restore read."""
    full = spec.stage_in_bytes + spec.dataset_bytes
    if granted_ids and granted_ids <= staged_nodes:
        return 0.0, full + restore_bytes
    return full + restore_bytes, 0.0


class _NodeBackend(DataManagerBackend):
    """Shared sizing/QoS logic for backends that allocate storage nodes."""

    def _resolve(self, spec: StorageSpec, svc: "ProvisioningService") -> tuple[int, float]:
        """(node count, delivered aggregate write B/s) on an empty cluster."""
        req = spec.to_request()
        n = svc.scheduler.resolve_storage_nodes(req, assume_empty=True)
        policy = svc.scheduler.policy
        per_node = min(
            policy.node_capability_bw(node) for node in svc.cluster.storage_nodes
        )
        return n, n * per_node

    def _provision_s(self, spec: StorageSpec, svc: "ProvisioningService") -> float:
        policy = svc.scheduler.policy
        targets = policy.metadata_disks_per_node + policy.storage_disks_per_node
        return predict_deploy_time(targets, runtime=spec.runtime, fresh=True)

    def _check_sized(self, spec: StorageSpec, svc: "ProvisioningService") -> Optional[str]:
        if spec.to_request() is None:
            return "spec has no sizing; dedicated-node backends need nodes/capacity/bandwidth"
        try:
            n, bw = self._resolve(spec, svc)
        except AllocationError as e:
            return str(e)
        total = len(svc.cluster.storage_nodes)
        if n > total:
            return f"needs {n} storage nodes, cluster has {total}"
        if spec.qos.min_bandwidth is not None and bw < spec.qos.min_bandwidth:
            return (
                f"delivers {bw:.3g} B/s over {n} nodes, "
                f"below QoS floor {spec.qos.min_bandwidth:.3g} B/s"
            )
        t = self._provision_s(spec, svc)
        if spec.qos.max_provision_s is not None and t > spec.qos.max_provision_s:
            return (
                f"modeled deploy {t:.2f} s exceeds QoS ceiling "
                f"{spec.qos.max_provision_s:.2f} s"
            )
        return None


class EphemeralFSBackend(_NodeBackend):
    """BeeGFS-analogue on granted nodes; the paper's own data manager."""

    name = "ephemeralfs"
    scheduler_gated = True
    capabilities = BackendCapabilities(
        access=("posix",),
        lifetimes=frozenset(LifetimeClass),
        striping=True,
        mirroring=True,
        dedicated_nodes=True,
        zero_deploy=False,
        redundancy=("none", "mirror"),
    )

    def _check(self, spec, svc):
        if spec.lifetime is LifetimeClass.POOLED:
            pools = svc.pool_manager
            if pools is None:
                return (
                    "POOLED spec but no pool subsystem attached "
                    "(create a PERSISTENT session first)"
                )
            need = spec.dataset_bytes + spec.scratch_bytes
            if not pools.feasible(spec.datasets, spec.scratch_bytes):
                return (
                    f"no active pool can hold the {need:.3g} B working set "
                    f"({len(pools.active_pools)} active pools)"
                )
            if spec.qos.max_provision_s is not None and (
                pools.lease_attach_s > spec.qos.max_provision_s
            ):
                return "lease attach exceeds QoS provisioning ceiling"
            if spec.qos.min_bandwidth is not None:
                bw = self._pooled_bw(pools)
                if bw < spec.qos.min_bandwidth:
                    return (
                        f"best active pool delivers {bw:.3g} B/s, below QoS "
                        f"floor {spec.qos.min_bandwidth:.3g} B/s"
                    )
            return None
        return self._check_sized(spec, svc)

    @staticmethod
    def _pooled_bw(pools) -> float:
        """Aggregate write B/s of the best active pool (lease QoS basis)."""
        return max(
            (min(p.fs_model.raw_write_bw, p.fs_model.net_bw) for p in pools.active_pools),
            default=0.0,
        )

    def offer(self, spec, svc):
        if spec.lifetime is LifetimeClass.POOLED:
            pools = svc.pool_manager
            bw = self._pooled_bw(pools)
            t = pools.lease_attach_s
            return Offer(self.name, self._score(bw, spec, t, 0), 0, t, bw)
        n, bw = self._resolve(spec, svc)
        t = self._provision_s(spec, svc)
        return Offer(self.name, self._score(bw, spec, t, n), n, t, bw)

    def try_open(self, spec, offer, svc, *, n_compute=0, warm_nodes=frozenset(),
                 materialize=False, base_dir=None, now=0.0,
                 staged_nodes=frozenset(), restore_bytes=0.0,
                 restore_pool_id=None):
        if spec.lifetime is LifetimeClass.POOLED:
            return self._try_lease(spec, offer, svc, n_compute=n_compute, now=now,
                                   restore_bytes=restore_bytes,
                                   restore_pool_id=restore_pool_id)
        if spec.lifetime is LifetimeClass.PERSISTENT:
            return self._try_create_pool(spec, offer, svc, n_compute=n_compute, now=now)
        alloc = svc.scheduler.try_submit(
            JobRequest(spec.name, n_compute, storage=spec.to_request())
        )
        if alloc is None:
            return None
        plan = svc.provisioner.plan_for(
            alloc,
            mirror=spec.placement.mirror,
            stripe_size=spec.placement.stripe_size,
            runtime=spec.runtime,
        )
        ids = frozenset(n.node_id for n in alloc.storage_nodes)
        t_prov = predict_deploy_time(
            plan.targets_per_node, runtime=spec.runtime, fresh=not ids <= warm_nodes
        )
        stage_in, saved = _resume_stage_in(spec, ids, staged_nodes, restore_bytes)
        session = StorageSession(
            spec=spec,
            offer=offer,
            service=svc,
            opened_at=now,
            allocation=alloc,
            fs_model=svc.provisioner.model_for(plan),
            provision_time_s=t_prov,
            teardown_time_s=svc.teardown_time_s,
            stage_in_bytes=stage_in,
            stage_out_bytes=spec.stage_out_bytes,
            saved_bytes=saved,
            redundancy=_effective_redundancy(spec, self.capabilities, len(ids)),
        )
        if materialize:
            try:
                session.deployment = svc.provisioner.deploy(plan, base_dir)
            except Exception:
                # a failed deploy (e.g. base_dir collision) must not leak
                # the already-granted nodes
                session.release(now)
                raise
        return session

    def _try_lease(self, spec, offer, svc, *, n_compute, now, restore_bytes=0.0,
                   restore_pool_id=None):
        creq = JobRequest(spec.name, n_compute)
        # compute first (side-effect free): a failed compute fit must not
        # evict pool datasets for nothing
        if not svc.scheduler.can_allocate(creq):
            return None
        lease = svc.pool_manager.try_acquire(
            spec.name, spec.datasets, spec.scratch_bytes, now=now
        )
        if lease is None:
            return None
        alloc = svc.scheduler.try_submit(creq)
        if alloc is None:
            svc.pool_manager.release(lease, now)
            return None
        from ..pool.catalog import total_bytes

        restore = restore_bytes
        saved = lease.resident_bytes
        if restore and restore_pool_id is not None and lease.pool_id == restore_pool_id:
            # checkpoint residency (the warm-tree story extended to
            # checkpoints): the resume re-leased the very pool its last
            # commit was written into, and that pool has lost no node since
            # (a loss clears the caller's remembered pool id) — the restore
            # is a warm read inside the pool, not global-FS traffic
            saved += restore
            restore = 0.0
        return StorageSession(
            spec=spec,
            offer=offer,
            service=svc,
            opened_at=now,
            allocation=alloc,
            lease=lease,
            fs_model=svc.pool_manager.get(lease.pool_id).fs_model,
            provision_time_s=svc.pool_manager.lease_attach_s,
            teardown_time_s=0.0,   # the pool outlives the session
            # resuming leases re-attach warm: only datasets the catalog says
            # were evicted are in `missing` (re-staged); checkpoint state is
            # read back from the global FS on top unless it is still resident
            stage_in_bytes=spec.stage_in_bytes + total_bytes(lease.missing)
            + restore,
            stage_out_bytes=spec.stage_out_bytes,
            saved_bytes=saved,
        )

    def _try_create_pool(self, spec, offer, svc, *, n_compute=0, now):
        pools = svc.ensure_pools()
        from ..pool.pool import PoolState

        # the session's own compute nodes (the pool's storage allocation is
        # separate and outlives the session): grant them first so a busy
        # compute pool is a clean None, not a half-created pool
        alloc = None
        if n_compute:
            alloc = svc.scheduler.try_submit(JobRequest(spec.name, n_compute))
            if alloc is None:
                return None

        def _release_compute():
            if alloc is not None:
                svc.scheduler.release(alloc)

        for existing in pools.pools:
            if existing.name == spec.name and existing.state is PoolState.ACTIVE:
                # idempotent by name: a retried/replayed PERSISTENT spec
                # reattaches to the pool it already created instead of
                # colliding on the claimed base_dir — but only if the sizing
                # still resolves to the same node count (a silently smaller
                # pool would be a lie)
                want = svc.scheduler.resolve_storage_nodes(
                    spec.to_request(), assume_empty=True
                )
                have = len(existing.allocation.storage_nodes)
                if want != have:
                    _release_compute()
                    raise AllocationError(
                        f"{spec.name!r}: an ACTIVE pool of this name spans "
                        f"{have} nodes but the spec resolves to {want}; "
                        "retire it or pick another name"
                    )
                return StorageSession(
                    spec=spec,
                    offer=offer,
                    service=svc,
                    opened_at=now,
                    allocation=alloc,
                    pool=existing,
                    fs_model=existing.fs_model,
                    provision_time_s=0.0,   # already provisioned
                    teardown_time_s=0.0,
                )
        if not svc.scheduler.can_allocate(JobRequest(spec.name, 0, storage=spec.to_request())):
            _release_compute()
            return None
        try:
            pool = pools.create_pool(
                nodes=spec.nodes,
                capacity_bytes=spec.capacity_bytes,
                capability_bw=spec.bandwidth,
                cap_bytes=spec.capacity_cap_bytes,
                name=spec.name,
                runtime=spec.runtime,
                now=now,
            )
        except Exception:
            _release_compute()
            raise
        return StorageSession(
            spec=spec,
            offer=offer,
            service=svc,
            opened_at=now,
            allocation=alloc,
            pool=pool,
            fs_model=pool.fs_model,
            provision_time_s=pool.deploy_time_s,
            teardown_time_s=0.0,   # retirement/TTL drains it, not the session
        )


class GlobalFSBackend(DataManagerBackend):
    """The always-on Lustre-analogue: zero deploy, shared bandwidth."""

    name = "globalfs"
    scheduler_gated = True
    capabilities = BackendCapabilities(
        access=("posix",),
        lifetimes=frozenset({LifetimeClass.EPHEMERAL}),
        persistent_data=True,
        zero_deploy=True,
    )

    def __init__(self, capacity_bytes: float = 170e12):
        self.capacity_bytes = capacity_bytes

    def _aggregate_bw(self, svc) -> float:
        m = svc.globalfs_model
        return min(m.raw_write_bw, m.net_bw)

    def _check(self, spec, svc):
        if spec.nodes is not None:
            return "cannot grant dedicated storage nodes (always-on shared FS)"
        if spec.capacity_bytes is not None and spec.capacity_bytes > self.capacity_bytes:
            return (
                f"capacity {spec.capacity_bytes:.3g} B exceeds the shared "
                f"file system's {self.capacity_bytes:.3g} B"
            )
        bw = self._aggregate_bw(svc)
        if spec.bandwidth is not None and spec.bandwidth > bw:
            return f"aggregate bandwidth {bw:.3g} B/s below sized {spec.bandwidth:.3g} B/s"
        if spec.qos.min_bandwidth is not None and spec.qos.min_bandwidth > bw:
            return (
                f"aggregate bandwidth {bw:.3g} B/s below QoS floor "
                f"{spec.qos.min_bandwidth:.3g} B/s"
            )
        return None

    def offer(self, spec, svc):
        bw = self._aggregate_bw(svc)
        return Offer(self.name, self._score(bw, spec, 0.0, 0), 0, 0.0, bw)

    def try_open(self, spec, offer, svc, *, n_compute=0, warm_nodes=frozenset(),
                 materialize=False, base_dir=None, now=0.0,
                 staged_nodes=frozenset(), restore_bytes=0.0,
                 restore_pool_id=None):
        alloc = None
        if n_compute:
            alloc = svc.scheduler.try_submit(JobRequest(spec.name, n_compute))
            if alloc is None:
                return None
        if materialize:
            svc.materialized_globalfs(create=True)
        return StorageSession(
            spec=spec,
            offer=offer,
            service=svc,
            opened_at=now,
            allocation=alloc,
            fs_model=svc.globalfs_model,
            provision_time_s=0.0,
            teardown_time_s=0.0,
            # shared datasets already live on the global FS: nothing to move,
            # and the avoided copies are reported as saved traffic; resuming
            # callers re-read their checkpoint (a within-FS copy)
            stage_in_bytes=spec.stage_in_bytes + restore_bytes,
            stage_out_bytes=spec.stage_out_bytes,
            saved_bytes=spec.dataset_bytes,
        )


class KVStoreBackend(_NodeBackend):
    """Hash-partitioned KV store on granted nodes (``access="kv"``)."""

    name = "kvstore"
    scheduler_gated = True
    capabilities = BackendCapabilities(
        access=("kv",),
        lifetimes=frozenset({LifetimeClass.EPHEMERAL}),
        mirroring=True,          # replicate=True mirrors to the next node
        dedicated_nodes=True,
        redundancy=("none", "mirror"),
    )

    def _check(self, spec, svc):
        reason = self._check_sized(spec, svc)
        if reason is not None:
            return reason
        if spec.placement.mirror:
            n = svc.scheduler.resolve_storage_nodes(spec.to_request(), assume_empty=True)
            if n < 2:
                return "replication (mirror) needs >= 2 storage nodes"
        return None

    def offer(self, spec, svc):
        n, bw = self._resolve(spec, svc)
        t = self._provision_s(spec, svc)
        return Offer(self.name, self._score(bw, spec, t, n), n, t, bw)

    def try_open(self, spec, offer, svc, *, n_compute=0, warm_nodes=frozenset(),
                 materialize=False, base_dir=None, now=0.0,
                 staged_nodes=frozenset(), restore_bytes=0.0,
                 restore_pool_id=None):
        alloc = svc.scheduler.try_submit(
            JobRequest(spec.name, n_compute, storage=spec.to_request())
        )
        if alloc is None:
            return None
        plan = svc.provisioner.plan_for(alloc, runtime=spec.runtime)
        ids = frozenset(n.node_id for n in alloc.storage_nodes)
        stage_in, saved = _resume_stage_in(spec, ids, staged_nodes, restore_bytes)
        session = StorageSession(
            spec=spec,
            offer=offer,
            service=svc,
            opened_at=now,
            allocation=alloc,
            fs_model=svc.provisioner.model_for(plan),
            provision_time_s=predict_deploy_time(
                plan.targets_per_node, runtime=spec.runtime, fresh=not ids <= warm_nodes
            ),
            teardown_time_s=svc.teardown_time_s,
            stage_in_bytes=stage_in,
            stage_out_bytes=spec.stage_out_bytes,
            saved_bytes=saved,
            redundancy=_effective_redundancy(spec, self.capabilities, len(ids)),
        )
        if materialize:
            from ..core.kvstore import EphemeralKV

            base_dir = base_dir or tempfile.mkdtemp(prefix="kv-")
            try:
                svc.provisioner.claim_tree(base_dir, owner=spec.name)
                try:
                    session.kv = EphemeralKV(
                        alloc.storage_nodes, base_dir, replicate=spec.placement.mirror
                    )
                except Exception:
                    svc.provisioner.release_tree(base_dir)
                    raise
            except Exception:
                session.release(now)   # failed materialize must not leak nodes
                raise
        return session


class NullBackend(DataManagerBackend):
    """Dry-run backend: accepts anything at zero cost, by explicit request."""

    name = "null"
    scheduler_gated = True
    capabilities = BackendCapabilities(
        access=("posix", "kv"),
        lifetimes=frozenset(LifetimeClass),
        striping=True,
        mirroring=True,
        zero_deploy=True,
    )

    def _check(self, spec, svc):
        if self.name not in spec.managers:
            return "dry-run backend; must be requested by name in managers"
        return None

    def offer(self, spec, svc):
        return Offer(self.name, 0.0, 0, 0.0, float("inf"))

    def try_open(self, spec, offer, svc, *, n_compute=0, warm_nodes=frozenset(),
                 materialize=False, base_dir=None, now=0.0,
                 staged_nodes=frozenset(), restore_bytes=0.0,
                 restore_pool_id=None):
        alloc = None
        if n_compute:
            alloc = svc.scheduler.try_submit(JobRequest(spec.name, n_compute))
            if alloc is None:
                return None
        return StorageSession(
            spec=spec, offer=offer, service=svc, opened_at=now, allocation=alloc
        )


class BackendRegistry:
    """Ordered name -> backend registry the service negotiates over."""

    def __init__(self, backends: Optional[list[DataManagerBackend]] = None):
        self._backends: dict[str, DataManagerBackend] = {}
        #: bumped on registration; offers cached against the old set go stale
        self.version = 0
        for b in backends or []:
            self.register(b)

    def register(self, backend: DataManagerBackend) -> None:
        if backend.name in self._backends:
            raise ValueError(f"backend {backend.name!r} already registered")
        self._backends[backend.name] = backend
        self.version += 1

    def get(self, name: str) -> Optional[DataManagerBackend]:
        return self._backends.get(name)

    def names(self) -> tuple[str, ...]:
        return tuple(self._backends)

    def __iter__(self) -> Iterator[DataManagerBackend]:
        return iter(self._backends.values())

    def __len__(self) -> int:
        return len(self._backends)


def default_registry() -> BackendRegistry:
    """The stock negotiation set: ephemeral FS, global FS, KV, dry-run."""
    return BackendRegistry(
        [EphemeralFSBackend(), GlobalFSBackend(), KVStoreBackend(), NullBackend()]
    )
