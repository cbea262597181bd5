"""Pool-backed model replicas: stage weights once, lease per replica.

The paper's allocatable-storage claim applied to serving: model weights are
a *dataset*, so a fleet stages them **once** into a PERSISTENT pool and
every replica attaches a POOLED lease over the same
``StorageSpec -> open_session()`` path jobs use. Cold-start is then lease
attach plus weight page-in priced by the calibrated perfmodel — not a
per-replica deploy + re-stage — which is exactly what makes alert-driven
scale-up cheap enough to chase a traffic burst.

Lifecycle: a replica is STARTING while its lease attaches and weights page
in, ACTIVE while it serves, DRAINING once the autoscaler marks it down (it
finishes in-flight decodes, admits nothing), and STOPPED when its lease is
released. The pool — and the resident weights — outlive every replica.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from ..chaos.retry import drive_retries
from ..core.staging import modeled_stage_time
from ..obs.trace import NULL_RECORDER
from ..pool.catalog import DatasetRef
from ..provision.spec import LifetimeClass, StorageSpec
from .batching import BatchEngine, ServingPerf


class ReplicaState(enum.Enum):
    STARTING = "starting"
    ACTIVE = "active"
    DRAINING = "draining"
    STOPPED = "stopped"


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """What a fleet serves: weight footprint plus per-replica shape."""

    name: str
    weight_bytes: float
    n_slots: int = 8
    perf: ServingPerf = ServingPerf()

    def __post_init__(self):
        if self.weight_bytes <= 0:
            raise ValueError(f"weight_bytes must be positive, got {self.weight_bytes}")


class Replica:
    """One serving instance: a pool lease, a batch engine, a step loop.

    The step loop is the replica's whole scheduler: while awake it prefers
    admitting a prefill (bounds TTFT), otherwise runs a decode step, and
    goes idle when it has neither. ``source`` is the campaign, duck-typed:
    ``pull() -> Request | None``, ``request_done(req)``.
    """

    def __init__(self, rid: int, name: str, *, session, batch: BatchEngine,
                 engine, rset: "ReplicaSet", source):
        self.rid = rid
        self.name = name
        self.session = session
        self.batch = batch
        self.engine = engine
        self.rset = rset
        self.source = source
        self.state = ReplicaState.STARTING
        self.started_at: float = 0.0
        self.active_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self.cold_start_s: float = 0.0
        self.idle_since: Optional[float] = None
        self._busy = False
        #: request whose prefill is in flight (evacuated on a node kill)
        self._inflight = None

    # -- step loop ------------------------------------------------------------
    def wake(self) -> None:
        """Nudge an idle replica (new arrival, activation). No-op while a
        phase is in flight — re-entrancy is what the ``_busy`` latch
        prevents, so a burst of same-instant arrivals wakes each idle
        replica exactly once."""
        if self._busy or self.state not in (ReplicaState.ACTIVE, ReplicaState.DRAINING):
            return
        self._busy = True
        self._step()

    def _step(self) -> None:
        now = self.engine.now
        batch = self.batch
        if self.state is ReplicaState.ACTIVE and batch.has_free_slot():
            req = self.source.pull()
            if req is not None:
                self.idle_since = None
                req.replica = self.name
                self._inflight = req
                dt = batch.begin_prefill(req, now)
                self.engine.after(dt, lambda: self._prefill_done(req))
                return
        if batch.n_active:
            self.idle_since = None
            self.engine.after(batch.decode_step_s(), self._decode_done)
            return
        # nothing to prefill, nothing decoding: park until woken
        self._busy = False
        self.idle_since = now
        if self.state is ReplicaState.DRAINING:
            self.rset._finish_drain(self, now)

    def _prefill_done(self, req) -> None:
        if self.state is ReplicaState.STOPPED:
            return          # killed mid-prefill; the request was requeued
        self._inflight = None
        done = self.batch.finish_prefill(req, self.engine.now)
        if done is not None:
            self.source.request_done(done)
        self._step()

    def _decode_done(self) -> None:
        if self.state is ReplicaState.STOPPED:
            return          # killed mid-decode; active slots were requeued
        for req in self.batch.advance_decode(self.engine.now):
            self.source.request_done(req)
        self._step()


class ReplicaSet:
    """The fleet: one PERSISTENT weight pool, N leased replicas.

    ``listener`` (optional, duck-typed) hears ``replica_active(r)`` and
    ``replica_stopped(r)`` — the campaign uses it to kick queued work onto
    a freshly warm replica.
    """

    def __init__(
        self,
        service,
        engine,
        model: ModelProfile,
        *,
        pool_nodes: int = 2,
        n_compute_per_replica: int = 1,
        scratch_bytes: float = 0.0,
        managers: tuple = ("ephemeralfs",),
        name: str = "serving",
        recorder=NULL_RECORDER,
        source=None,
        listener=None,
    ):
        self.service = service
        self.engine = engine
        self.model = model
        self.pool_nodes = pool_nodes
        self.n_compute = n_compute_per_replica
        self.scratch_bytes = scratch_bytes
        self.managers = tuple(managers)
        self.name = name
        self.recorder = recorder
        self.source = source
        self.listener = listener
        self.weights = DatasetRef(f"weights/{model.name}", model.weight_bytes)
        self.pool_session = None
        self.weights_ready_at: Optional[float] = None
        self.weight_stage_s: float = 0.0
        self.replicas: List[Replica] = []
        #: ``(t, "up" | "down" | "stopped" | "up-denied", replica_name, reason)``
        self.scale_events: list = []
        self._n_live = 0
        self._last_t = 0.0
        self.replica_seconds = 0.0
        self.peak_replicas = 0

    # -- weight staging (exactly once) ----------------------------------------
    def stage_weights(self, now: float) -> float:
        """Create the PERSISTENT pool and stage the weights into it via a
        short-lived loader lease; returns the virtual time the weights are
        RESIDENT. Every later replica attach is a pure catalog hit — the
        trace's ``lease_attached`` events carry the proof (one miss total,
        from the loader)."""
        pool_spec = StorageSpec(
            f"{self.name}-pool",
            nodes=self.pool_nodes,
            lifetime=LifetimeClass.PERSISTENT,
            managers=self.managers,
        )
        self.pool_session = self.service.open_session(pool_spec, now=now)
        t = now + self.pool_session.provision_time_s
        loader = self.service.open_session(
            StorageSpec(
                f"{self.name}-weights",
                lifetime=LifetimeClass.POOLED,
                datasets=(self.weights,),
                managers=self.managers,
            ),
            now=t,
        )
        t += loader.provision_time_s + loader.stage_in_time_s
        loader.mark_staged(t)
        loader.release(t)
        self.weights_ready_at = t
        self.weight_stage_s = t - now
        rec = self.recorder
        if rec.enabled:
            rec.events.append((
                "weights_staged", t, self.model.name,
                {"bytes": self.model.weight_bytes, "stage_s": self.weight_stage_s,
                 "pool": pool_spec.name},
            ))
        return t

    # -- scaling --------------------------------------------------------------
    def scale_up(self, now: float, reason: str = "") -> Optional[Replica]:
        """Attach a lease and start a replica; ACTIVE after the cold-start
        (attach + perfmodel-priced weight page-in). ``None`` when the
        cluster can't grant the lease or compute nodes right now."""
        rid = len(self.replicas)
        spec = StorageSpec(
            f"{self.name}-r{rid:02d}",
            lifetime=LifetimeClass.POOLED,
            datasets=(self.weights,),
            stage_out_bytes=self.scratch_bytes,
            managers=self.managers,
        )
        session = self.service.try_open_session(
            spec, n_compute=self.n_compute, now=now
        )
        if session is None:
            self.scale_events.append((now, "up-denied", f"{self.name}-r{rid:02d}", reason))
            return None
        # page-in: replicas read the resident weights out of the pool into
        # device memory; an evicted dataset also re-pays its stage-in
        page_in_s = modeled_stage_time(
            self.model.weight_bytes, session.fs_model, None, spec.n_streams
        )
        cold = session.provision_time_s + session.stage_in_time_s + page_in_s
        r = Replica(
            rid, f"{self.name}-r{rid:02d}",
            session=session,
            batch=BatchEngine(self.model.n_slots, self.model.perf),
            engine=self.engine, rset=self, source=self.source,
        )
        r.started_at = now
        r.cold_start_s = cold
        self.replicas.append(r)
        self._account(now)
        self._n_live += 1
        self.peak_replicas = max(self.peak_replicas, self._n_live)
        self.scale_events.append((now, "up", r.name, reason))
        rec = self.recorder
        if rec.enabled:
            rec.events.append((
                "replica", now, r.name,
                {"state": "starting", "cold_start_s": cold,
                 "page_in_s": page_in_s, "restage_s": session.stage_in_time_s,
                 "reason": reason},
            ))
        self.engine.at(now + cold, lambda: self._activate(r))
        return r

    def _activate(self, r: Replica) -> None:
        if r.state is not ReplicaState.STARTING:
            return
        now = self.engine.now
        r.state = ReplicaState.ACTIVE
        r.active_at = now
        r.idle_since = now
        # publish (or re-publish, after an eviction re-stage) residency and
        # refresh the pool's LRU clock for the weights
        r.session.mark_staged(now)
        rec = self.recorder
        if rec.enabled:
            rec.events.append(("replica", now, r.name, {"state": "active"}))
        if self.listener is not None:
            self.listener.replica_active(r)

    def scale_down(self, r: Replica, now: float, reason: str = "") -> None:
        """Begin draining ``r``: no new admissions; the lease releases when
        its last decode finishes. The pool keeps the weights resident."""
        if r.state is not ReplicaState.ACTIVE:
            return
        r.state = ReplicaState.DRAINING
        self.scale_events.append((now, "down", r.name, reason))
        rec = self.recorder
        if rec.enabled:
            rec.events.append((
                "replica", now, r.name, {"state": "draining", "reason": reason}
            ))
        if not r._busy:
            self._finish_drain(r, now)

    def _finish_drain(self, r: Replica, now: float) -> None:
        if r.state is not ReplicaState.DRAINING:
            return
        r.state = ReplicaState.STOPPED
        r.stopped_at = now
        r._busy = False
        self._account(now)
        self._n_live -= 1
        r.session.release(now)
        self.scale_events.append((now, "stopped", r.name, ""))
        rec = self.recorder
        if rec.enabled:
            rec.events.append(("replica", now, r.name, {"state": "stopped"}))
        if self.listener is not None:
            self.listener.replica_stopped(r)

    # -- failure domain (chaos engine) ----------------------------------------
    def kill(self, r: Replica, now: float, reason: str = "node-loss") -> list:
        """Hard-stop ``r`` (its storage node died): every in-flight request
        — the prefill in flight and every active decode slot — aborts back
        to the source queue, the lease releases, and the autoscaler's floor
        restores the fleet on its next control tick. Returns the aborted
        requests (already requeued when a source is attached)."""
        if r.state is ReplicaState.STOPPED:
            return []
        r.state = ReplicaState.STOPPED
        r.stopped_at = now
        r._busy = False
        aborted = []
        if r._inflight is not None:
            aborted.append(r._inflight)
            r._inflight = None
        aborted.extend(r.batch.abort_all())
        self._account(now)
        self._n_live -= 1
        r.session.release(now)
        self.scale_events.append((now, "killed", r.name, reason))
        rec = self.recorder
        if rec.enabled:
            rec.events.append((
                "replica", now, r.name,
                {"state": "killed", "aborted": len(aborted), "reason": reason},
            ))
        if self.source is not None:
            # reversed: the source pushes each to the queue *front*, so the
            # earliest-admitted aborted request re-admits first
            for req in reversed(aborted):
                self.source.requeue(req)
        if self.listener is not None:
            self.listener.replica_stopped(r)
        return aborted

    def on_node_down(self, node_id: str, now: Optional[float] = None,
                     *, retry=None) -> List[Replica]:
        """Absorb a storage-node loss across the fleet.

        Replicas leasing from an affected pool (or whose own session spans
        the node) are killed — leases release first, unpinning the weights
        — then each affected pool takes the loss (residency invalidated,
        capacity shrunk) and, when a :class:`~repro.chaos.RetryPolicy` is
        passed, self-heals by backfilling from free nodes on its cadence.
        The next scale-up re-stages the weights through the ordinary miss
        path: degraded fleets never serve stale residency."""
        now = self.engine.now if now is None else now
        pm = self.service.pool_manager
        pools = pm.affected_pools(node_id) if pm is not None else ()
        pool_ids = {p.pool_id for p in pools}
        victims = []
        for r in self.replicas:
            if r.state is ReplicaState.STOPPED:
                continue
            lease = r.session.lease
            if (lease is not None and lease.pool_id in pool_ids) or any(
                n.node_id == node_id for n in r.session.storage_nodes
            ):
                victims.append(r)
        for r in victims:
            self.kill(r, now, reason=f"node-loss:{node_id}")
        for pool in pools:
            pm.on_node_down(pool, node_id, now)
            if retry is not None:
                drive_retries(
                    self.engine,
                    retry,
                    f"pool{pool.pool_id}:{node_id}",
                    lambda p=pool: pm.backfill(p, self.engine.now),
                )
        return victims

    # -- accounting / views ---------------------------------------------------
    def _account(self, now: float) -> None:
        """Advance the replica-seconds integral to ``now`` (call before any
        ``_n_live`` change, and once at campaign end)."""
        if now > self._last_t:
            self.replica_seconds += self._n_live * (now - self._last_t)
            self._last_t = now

    def finalize(self, now: float) -> None:
        self._account(now)

    @property
    def n_live(self) -> int:
        """Replicas currently holding a lease (STARTING/ACTIVE/DRAINING)."""
        return self._n_live

    @property
    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.state is not ReplicaState.STOPPED]

    @property
    def active(self) -> List[Replica]:
        return [r for r in self.replicas if r.state is ReplicaState.ACTIVE]

    def idle_replicas(self, now: float, ttl_s: float) -> List[Replica]:
        """ACTIVE replicas idle for at least ``ttl_s``, lowest rid first —
        the deterministic scale-down victim ordering."""
        return [
            r for r in self.replicas
            if r.state is ReplicaState.ACTIVE
            and r.idle_since is not None
            and now - r.idle_since >= ttl_s
        ]

    def wake_one(self) -> None:
        """Wake the lowest-rid idle ACTIVE replica (one arrival, one wake)."""
        for r in self.replicas:
            if r.state is ReplicaState.ACTIVE and not r._busy:
                r.wake()
                return
