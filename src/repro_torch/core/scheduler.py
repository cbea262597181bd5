"""Batch scheduler with storage as an allocatable resource (paper §III-A/B).

The paper's key move: instead of the rigid SLURM Burst-Buffer plugin, the
re-purposed DataWarp nodes are exposed through a plain SLURM *constraint*
(``--constraint=storage``), so a job requests two allocations -- compute nodes
and storage nodes -- through the ordinary scheduler path.

This module reproduces that model and adds the paper's §V sizing trade-off as
a first-class request: a job may ask for storage by **node count**, by
**capacity** (bytes), or by **capability** (bandwidth); the scheduler resolves
capacity/capability to a node count using the deployment policy (how many
disks per node take the storage role).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Optional

from ..obs.trace import NULL_RECORDER
from .resources import ClusterSpec, ComputeNode, StorageNode


class AllocationError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True, slots=True)
class StorageRequest:
    """Exactly one of ``nodes`` / ``capacity_bytes`` / ``capability_bw`` must
    be set (the paper's §V: users target either quantity of bytes or speed)."""

    nodes: Optional[int] = None
    capacity_bytes: Optional[float] = None
    capability_bw: Optional[float] = None      # aggregate write B/s target

    def __post_init__(self) -> None:
        n_set = sum(x is not None for x in (self.nodes, self.capacity_bytes, self.capability_bw))
        if n_set != 1:
            raise ValueError("set exactly one of nodes/capacity_bytes/capability_bw")
        if self.nodes is not None and self.nodes <= 0:
            raise ValueError(f"storage node count must be positive, got {self.nodes}")
        if self.capacity_bytes is not None and self.capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {self.capacity_bytes}")
        if self.capability_bw is not None and self.capability_bw <= 0:
            raise ValueError(f"capability_bw must be positive, got {self.capability_bw}")


@dataclasses.dataclass(frozen=True, slots=True)
class JobRequest:
    job_name: str
    n_compute: int
    storage: Optional[StorageRequest] = None
    constraint: str = "storage"

    def __post_init__(self) -> None:
        if self.n_compute < 0:
            raise ValueError(f"n_compute must be >= 0, got {self.n_compute}")


@dataclasses.dataclass(frozen=True, slots=True)
class Allocation:
    job_id: int
    job_name: str
    compute_nodes: tuple[ComputeNode, ...]
    storage_nodes: tuple[StorageNode, ...]


@dataclasses.dataclass(frozen=True)
class SizingPolicy:
    """How storage requests map to nodes. The paper's default layout is one
    metadata disk + two storage disks per DataWarp node (§IV-A)."""

    storage_disks_per_node: int = 2
    metadata_disks_per_node: int = 1

    def node_capacity_bytes(self, node: StorageNode) -> float:
        """Usable bytes one node contributes (its storage-role disks)."""
        return sum(
            d.spec.capacity_bytes for d in node.disks[: self.storage_disks_per_node]
        )

    def node_capability_bw(self, node: StorageNode) -> float:
        """Aggregate write bandwidth one node contributes (storage-role disks)."""
        return sum(
            d.spec.write_bw for d in node.disks[: self.storage_disks_per_node]
        )

    def nodes_for_capacity(self, node: StorageNode, capacity: float) -> int:
        return max(1, math.ceil(capacity / self.node_capacity_bytes(node)))

    def nodes_for_capability(self, node: StorageNode, bw: float) -> int:
        return max(1, math.ceil(bw / self.node_capability_bw(node)))


class Scheduler:
    """FIFO allocator over a static cluster inventory.

    Invariants (property-tested):
      * a node is never in two live allocations;
      * ``release`` returns every node of the allocation to the free pool;
      * storage nodes are only granted to requests carrying the storage
        constraint (the paper's access-control mechanism).

    The free pools are *indexed*: a min-heap of node ids carries exactly one
    entry per free node (grants pop, releases push), so handing out the
    lowest-id nodes is O(log M) per node and bit-for-bit the order of the
    old full-sort path. Two lazy-deletion heaps keyed by each node's static
    capacity / bandwidth contribution answer the weakest-free-node question
    that capacity- and bandwidth-sized requests resolve against, making
    ``resolve_storage_nodes`` / ``demand`` / ``can_allocate`` O(1) amortized
    instead of O(M) scans per admission. ``epoch`` counts grant/release
    batches; anything cached off the free pool upstream (queue-policy keys,
    negotiated offers) invalidates against it.
    """

    def __init__(self, cluster: ClusterSpec, policy: SizingPolicy | None = None):
        self.cluster = cluster
        self.policy = policy or SizingPolicy()
        self._free_compute = {n.node_id: n for n in cluster.compute_nodes}
        self._free_storage = {n.node_id: n for n in cluster.storage_nodes}
        self._live: dict[int, Allocation] = {}
        # reservation ledger: live allocation id -> projected release time,
        # reported by callers with a duration model (the orchestrator's
        # session costs). Feeds earliest_fit/projected_free_at — the EASY
        # backfill reservation questions. Purely advisory: never consulted
        # by grants or releases themselves.
        self._projected: dict[int, float] = {}
        self._next_id = itertools.count(1)
        #: bumped on every grant/release batch (cache-invalidation signal)
        self.epoch = 0
        #: observability sink for grant/release events (no-op by default;
        #: the recorder stamps virtual time itself — the scheduler is clockless)
        self.recorder = NULL_RECORDER
        # -- indexed ledger ---------------------------------------------------
        # a sorted list is a valid min-heap; one entry per free node
        self._compute_ids = sorted(self._free_compute)
        self._storage_ids = sorted(self._free_storage)
        # per-node contributions are static under the (frozen) sizing policy
        self._node_cap = {
            n.node_id: self.policy.node_capacity_bytes(n)
            for n in cluster.storage_nodes
        }
        self._node_bw = {
            n.node_id: self.policy.node_capability_bw(n)
            for n in cluster.storage_nodes
        }
        self._free_cap_heap = [(c, nid) for nid, c in self._node_cap.items()]
        self._free_bw_heap = [(b, nid) for nid, b in self._node_bw.items()]
        heapq.heapify(self._free_cap_heap)
        heapq.heapify(self._free_bw_heap)
        # -- failure domain (chaos engine) ------------------------------------
        # dead nodes are *parked*: a free node moves straight into
        # ``_down_storage``; a node inside a live allocation is flagged in
        # ``_down_pending`` and parked by ``release`` instead of freed. Both
        # dicts are empty in chaos-off campaigns, and ``release`` only takes
        # the slow path while ``_down_pending`` is non-empty — so the hot
        # path is one falsy check and replay stays bit-for-bit.
        self._down_storage: dict = {}
        self._down_pending: set = set()
        self._total_storage_cap = sum(self._node_cap.values())
        # weakest node over the whole inventory (the assume_empty candidates)
        if cluster.storage_nodes:
            self._empty_weakest_cap = min(
                cluster.storage_nodes, key=self.policy.node_capacity_bytes
            )
            self._empty_weakest_bw = min(
                cluster.storage_nodes, key=self.policy.node_capability_bw
            )
            self._empty_cap_min = min(self._node_cap.values())
            self._empty_bw_min = min(self._node_bw.values())
        # sizing with the stock SizingPolicy arithmetic is pure
        # ceil(request / weakest-contribution): resolve it from the cached
        # per-node values instead of re-summing disk specs per call.
        # Subclasses overriding the nodes_for_* hooks keep the node-object
        # path.
        self._stock_sizing = (
            type(self.policy).nodes_for_capacity is SizingPolicy.nodes_for_capacity
            and type(self.policy).nodes_for_capability is SizingPolicy.nodes_for_capability
        )

    def _weakest_free(self, heap: list) -> StorageNode:
        """Lazy-deletion min: drop stale heads (granted nodes, or duplicate
        entries left by earlier release/grant cycles of a now-busy node)."""
        free = self._free_storage
        while heap and heap[0][1] not in free:
            heapq.heappop(heap)
        assert heap, "weakest-free query on an empty free pool"
        return free[heap[0][1]]

    def _free_min(self, heap: list) -> float:
        """Weakest free node's cached contribution (value, not node)."""
        free = self._free_storage
        while heap and heap[0][1] not in free:
            heapq.heappop(heap)
        return heap[0][0]

    def free_min_capacity(self) -> Optional[float]:
        """Weakest free node's capacity contribution (None: free pool empty).
        With the whole-inventory min, this is the full sizing state: two
        capacity/bandwidth requests resolve identically whenever these are
        unchanged — what dispatchers key refusal caches on."""
        return self._free_min(self._free_cap_heap) if self._free_storage else None

    def free_min_bandwidth(self) -> Optional[float]:
        return self._free_min(self._free_bw_heap) if self._free_storage else None

    # -- introspection -------------------------------------------------------
    @property
    def live_allocations(self) -> tuple[Allocation, ...]:
        return tuple(self._live.values())

    def free_counts(self) -> tuple[int, int]:
        return len(self._free_compute), len(self._free_storage)

    # -- failure domain (chaos engine) ---------------------------------------
    @property
    def down_storage_nodes(self) -> frozenset:
        """Ids of storage nodes currently marked down (parked free nodes
        plus dead nodes still inside live allocations)."""
        return frozenset(self._down_storage) | frozenset(self._down_pending)

    @property
    def healthy_capacity_fraction(self) -> float:
        """Fraction of nominal storage capacity on healthy nodes — the
        availability gauge chaos campaigns chart. 1.0 with no storage."""
        total = self._total_storage_cap
        if not total:
            return 1.0
        down = sum(self._node_cap[nid] for nid in self._down_storage)
        down += sum(self._node_cap[nid] for nid in self._down_pending)
        return 1.0 - down / total

    def mark_node_down(self, node_id: str) -> bool:
        """Take a storage node out of service.

        A free node leaves the free pool immediately; a node held by a live
        allocation is flagged and parked when that allocation releases (the
        blast-radius handling upstream decides what happens to the holder).
        Returns True when the node was free. Idempotent for an already-down
        node; raises :class:`AllocationError` for unknown node ids.
        """
        if node_id in self._down_storage or node_id in self._down_pending:
            return node_id in self._down_storage
        if node_id not in self._node_cap:
            raise AllocationError(f"unknown storage node {node_id!r}")
        node = self._free_storage.pop(node_id, None)
        if node is not None:
            # node death is rare: the O(M) list fix-up is fine, and keeps
            # the one-entry-per-free-node id-heap invariant _grant pops by
            self._storage_ids.remove(node_id)
            heapq.heapify(self._storage_ids)
            self._down_storage[node_id] = node
            self.epoch += 1
            return True
        self._down_pending.add(node_id)
        self.epoch += 1
        return False

    def mark_node_up(self, node_id: str) -> bool:
        """Return a repaired storage node to service.

        A parked node rejoins the free pool; a dead-flagged node still held
        by a live allocation is simply unflagged (it frees normally on
        release). Returns True when the node rejoined the free pool now.
        Idempotent for a node that is not down.
        """
        node = self._down_storage.pop(node_id, None)
        if node is not None:
            self._free_storage[node_id] = node
            heapq.heappush(self._storage_ids, node_id)
            heapq.heappush(self._free_cap_heap, (self._node_cap[node_id], node_id))
            heapq.heappush(self._free_bw_heap, (self._node_bw[node_id], node_id))
            self.epoch += 1
            return True
        if node_id in self._down_pending:
            self._down_pending.discard(node_id)
            self.epoch += 1
        return False

    # -- sizing (paper §V trade-off) ----------------------------------------
    def resolve_storage_nodes(
        self, req: StorageRequest, *, assume_empty: bool = False
    ) -> int:
        """Resolve a capacity/capability request to a node count.

        Sizing is against the **minimum** per-node contribution across the
        candidate nodes, so any subset the allocator picks delivers at least
        the requested bytes/bandwidth — on heterogeneous storage nodes a
        single-prototype sizing (the old ``storage_nodes[0]``) over- or
        under-sizes whenever node 0 isn't the weakest.

        Candidates are the currently free storage nodes (what a grant would
        actually draw from); with ``assume_empty`` (the feasibility question
        "could this ever fit?") or an exhausted free pool, the whole
        inventory. Min over the free subset >= min over all nodes, so the
        empty-cluster count is the largest and feasibility stays conservative.
        """
        if not self.cluster.storage_nodes:
            raise AllocationError("cluster has no storage nodes")
        if req.nodes is not None:
            return req.nodes
        whole_inventory = assume_empty or not self._free_storage
        if req.capacity_bytes is not None:
            if self._stock_sizing:
                cap = (
                    self._empty_cap_min
                    if whole_inventory
                    else self._free_min(self._free_cap_heap)
                )
                return max(1, math.ceil(req.capacity_bytes / cap))
            weakest = (
                self._empty_weakest_cap
                if whole_inventory
                else self._weakest_free(self._free_cap_heap)
            )
            return self.policy.nodes_for_capacity(weakest, req.capacity_bytes)
        assert req.capability_bw is not None
        if self._stock_sizing:
            bw = (
                self._empty_bw_min
                if whole_inventory
                else self._free_min(self._free_bw_heap)
            )
            return max(1, math.ceil(req.capability_bw / bw))
        weakest = (
            self._empty_weakest_bw
            if whole_inventory
            else self._weakest_free(self._free_bw_heap)
        )
        return self.policy.nodes_for_capability(weakest, req.capability_bw)

    # -- feasibility (orchestrator queueing path) ----------------------------
    def demand(self, req: JobRequest, *, assume_empty: bool = False) -> tuple[int, int]:
        """Resolve a request to ``(n_compute, n_storage)`` node counts.

        Raises :class:`AllocationError` for requests that are malformed
        (storage without the storage constraint) -- these can never be
        granted, no matter how the cluster drains.
        """
        n_storage = 0
        if req.storage is not None:
            if req.constraint != "storage":
                raise AllocationError(
                    f"{req.job_name}: storage request without storage constraint"
                )
            n_storage = self.resolve_storage_nodes(req.storage, assume_empty=assume_empty)
        return req.n_compute, n_storage

    def feasible(self, req: JobRequest) -> bool:
        """Could this request ever be granted on an *empty* cluster?"""
        n_compute, n_storage = self.demand(req, assume_empty=True)
        return n_compute <= len(self.cluster.compute_nodes) and n_storage <= len(
            self.cluster.storage_nodes
        )

    def can_allocate(self, req: JobRequest) -> bool:
        """Does the request fit the free pool *right now*?"""
        n_compute, n_storage = self.demand(req)
        return n_compute <= len(self._free_compute) and n_storage <= len(
            self._free_storage
        )

    def try_submit(self, req: JobRequest) -> Optional[Allocation]:
        """Non-raising allocation path for queueing schedulers.

        Returns ``None`` when the cluster is merely *busy* (the request fits
        an empty cluster but not the current free pool) so callers can queue
        and retry; still raises :class:`AllocationError` for requests that
        can never be satisfied.

        Sizing is resolved exactly once per outcome: one empty-cluster
        resolution for the feasibility gate and one free-pool resolution that
        both the fit check and the grant reuse (the old path re-resolved in
        ``feasible``, ``can_allocate``, *and* ``submit``).
        """
        storage = req.storage
        n_compute = req.n_compute
        if storage is None:
            n_storage_empty = n_storage = 0
        else:
            if req.constraint != "storage":
                raise AllocationError(
                    f"{req.job_name}: storage request without storage constraint"
                )
            if storage.nodes is not None:
                n_storage_empty = n_storage = storage.nodes
            else:
                n_storage_empty = self.resolve_storage_nodes(storage, assume_empty=True)
                n_storage = -1          # resolved against the free pool below
        if n_compute > len(self.cluster.compute_nodes) or n_storage_empty > len(
            self.cluster.storage_nodes
        ):
            n_compute, n_storage = self.demand(req)
            raise AllocationError(
                f"{req.job_name}: wants {n_compute} compute / {n_storage} storage "
                "nodes but the cluster only has "
                f"{len(self.cluster.compute_nodes)} / {len(self.cluster.storage_nodes)}"
            )
        if n_storage < 0:
            n_storage = self.resolve_storage_nodes(storage)
        if n_compute > len(self._free_compute) or n_storage > len(self._free_storage):
            return None
        return self._grant(req, n_storage)

    # -- reservation ledger (EASY backfill substrate) ------------------------
    def note_projected_release(self, alloc: Allocation, t: Optional[float]) -> None:
        """Record when ``alloc`` is expected to release (from the caller's
        duration model). Overwrites any earlier projection; dropped
        automatically on :meth:`release`. ``t=None`` clears the projection:
        open-ended allocations (pilots accepting late task submissions)
        promise no release, so EASY proofs must not book holes against
        them, same as persistent pools. No-op for unknown allocations."""
        if alloc.job_id in self._live:
            if t is None:
                self._projected.pop(alloc.job_id, None)
            else:
                self._projected[alloc.job_id] = t

    def projected_release_of(self, alloc: Allocation) -> Optional[float]:
        return self._projected.get(alloc.job_id)

    def projected_free_at(self, t: float) -> tuple[int, int]:
        """(compute, storage) node counts of live allocations projected to
        have released by ``t``. Allocations with no projection (persistent
        pools above all) contribute nothing — they may never release."""
        dc = ds = 0
        for jid, tr in self._projected.items():
            if tr <= t:
                a = self._live[jid]
                dc += len(a.compute_nodes)
                ds += len(a.storage_nodes)
        return dc, ds

    def earliest_fit(
        self, n_compute: int, n_storage: int, now: float
    ) -> Optional[float]:
        """Earliest instant the demand could fit: the current free pool plus
        live allocations returned in projected-release order. ``None`` when
        the demand cannot fit even after every *projected* release — some
        needed nodes are held by allocations with no release projection, so
        no start time can be promised."""
        fc, fs = len(self._free_compute), len(self._free_storage)
        if fc >= n_compute and fs >= n_storage:
            return now
        for jid, t in sorted(self._projected.items(), key=lambda kv: (kv[1], kv[0])):
            a = self._live[jid]
            fc += len(a.compute_nodes)
            fs += len(a.storage_nodes)
            if fc >= n_compute and fs >= n_storage:
                return max(t, now)
        return None

    # -- allocation ----------------------------------------------------------
    def submit(self, req: JobRequest) -> Allocation:
        if req.n_compute > len(self._free_compute):
            raise AllocationError(
                f"{req.job_name}: wants {req.n_compute} compute nodes, "
                f"{len(self._free_compute)} free"
            )
        n_storage = 0
        if req.storage is not None:
            if req.constraint != "storage":
                raise AllocationError(
                    f"{req.job_name}: storage request without storage constraint"
                )
            n_storage = self.resolve_storage_nodes(req.storage)
            if n_storage > len(self._free_storage):
                raise AllocationError(
                    f"{req.job_name}: wants {n_storage} storage nodes, "
                    f"{len(self._free_storage)} free"
                )
        return self._grant(req, n_storage)

    def _grant(self, req: JobRequest, n_storage: int) -> Allocation:
        """Pop the lowest-id free nodes — the indexed equivalent of the old
        ``sorted(free)[:k]`` scan — and register the allocation."""
        pop = heapq.heappop
        compute = [
            self._free_compute.pop(pop(self._compute_ids))
            for _ in range(req.n_compute)
        ]
        storage = [
            self._free_storage.pop(pop(self._storage_ids))
            for _ in range(n_storage)
        ]
        alloc = Allocation(next(self._next_id), req.job_name, tuple(compute), tuple(storage))
        self._live[alloc.job_id] = alloc
        self.epoch += 1
        rec = self.recorder
        if rec.enabled:
            rec.sched_grant(alloc)
        return alloc

    def release(self, alloc: Allocation) -> None:
        if alloc.job_id not in self._live:
            raise AllocationError(f"allocation {alloc.job_id} is not live")
        del self._live[alloc.job_id]
        self._projected.pop(alloc.job_id, None)
        for n in alloc.compute_nodes:
            self._free_compute[n.node_id] = n
            heapq.heappush(self._compute_ids, n.node_id)
        pending = self._down_pending
        for n in alloc.storage_nodes:
            nid = n.node_id
            if pending and nid in pending:
                # died while allocated: park instead of freeing
                pending.discard(nid)
                self._down_storage[nid] = n
                continue
            self._free_storage[nid] = n
            heapq.heappush(self._storage_ids, nid)
            heapq.heappush(self._free_cap_heap, (self._node_cap[nid], nid))
            heapq.heappush(self._free_bw_heap, (self._node_bw[nid], nid))
        self.epoch += 1
        rec = self.recorder
        if rec.enabled:
            rec.sched_release(alloc)


def size_for_checkpoint(
    state_bytes: float,
    stall_budget_s: float,
    cluster: ClusterSpec,
    policy: SizingPolicy | None = None,
) -> StorageRequest:
    """Beyond-paper helper: derive a capability request from a training job's
    checkpoint size and the stall the job will tolerate per checkpoint.

    ``bw >= state_bytes / stall_budget`` -- the scheduler then converts the
    bandwidth target into a storage-node count via the sizing policy.
    """
    if stall_budget_s <= 0:
        raise ValueError("stall budget must be positive")
    return StorageRequest(capability_bw=state_bytes / stall_budget_s)
