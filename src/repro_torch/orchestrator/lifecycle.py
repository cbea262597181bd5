"""Job lifecycle state machine over the provisioning pipeline.

The paper's mechanism is a workflow — allocate compute+storage, deploy the
on-demand file system, stage in, run, stage out, tear down — and this module
drives it as one event-driven pipeline:

    QUEUED -> ALLOCATED -> PROVISIONING -> STAGING_IN -> RUNNING
           -> STAGING_OUT -> TEARDOWN -> DONE
                                 \\-> (fault) -> requeue or FAILED

Storage is obtained through exactly one path: every job's demands become a
declarative `StorageSpec`, the orchestrator's `ProvisioningService`
negotiates a backend (ephemeral FS, global FS, KV store, dry-run) and
grants a `StorageSession`, and the lifecycle advances its virtual clock by
the session's modeled costs (`provision_time_s` — C8 deploy, warm on
retries over the same nodes; `stage_in_time_s` — the slower of the
global-FS read and backend write paths; `teardown_time_s`). Releasing a
session returns whatever it held — nodes + file system for a job-scoped
grant, a pool lease for a pooled one — so teardown-vs-lease-drain is
session policy, not lifecycle code. A `FaultInjector` may trip any phase;
a tripped job releases its session and requeues (up to ``max_retries``),
the retry paying a *warm* redeploy when it lands on the same nodes (§IV-B1).

**Pool-backed jobs** (a POOLED `StorageSpec`, or the legacy
``WorkflowSpec(use_pool=True)``) ride the same state machine: negotiation
resolves them to a lease on a live persistent pool, the PROVISIONING slot
costs only the lease attach, TEARDOWN is free (the pool outlives the job),
and STAGING_IN moves only the dataset bytes *not already resident* on the
granted pool. Datasets staged by one job are cache hits for the next.

**Fault tolerance** (all opt-in; with every knob off the engine replays
PR 4 campaigns bit-for-bit):

* *Checkpoint-aware requeue* — a spec with ``checkpoint_every_s`` commits
  run progress on that cadence, each commit paying a modeled checkpoint
  write against the session's bandwidth (``checkpoint_bytes`` through the
  perfmodel; the `repro.checkpoint` burst-then-drain story priced for the
  virtual clock). A fault at the ``run`` phase then requeues a **resume
  attempt**: it pays only the uncommitted remainder of ``run_time_s``,
  re-reads ``checkpoint_bytes`` from the global FS when it lands cold, and
  re-stages only inputs that were actually lost — pool leases re-attach
  warm (the catalog knows what is still resident), and an ephemeral grant
  landing entirely on the nodes that staged it skips stage-in outright.
* *Preemption* — :meth:`Orchestrator.preempt` checkpoint-and-releases a
  RUNNING victim (progress commits through a final checkpoint write) and
  requeues it as a resume attempt that does not count against
  ``max_retries``. With a :class:`~.policies.PreemptionPolicy` installed,
  a blocked higher-``priority`` arrival triggers victim selection
  automatically (lowest priority first, most progress protected).
* *EASY reservations* — `EasyBackfillPolicy` books the blocked
  head-of-queue job a start time from the scheduler's projected-release
  ledger (fed by every started session's modeled span) and backfills only
  jobs that provably cannot delay it.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import Optional

from ..chaos.blast import resolve_blast_radius
from ..chaos.retry import drive_retries
from ..core.perfmodel import FSDeployment, dom_lustre
from ..core.scheduler import Allocation, AllocationError, JobRequest, StorageRequest
from ..obs.trace import NULL_RECORDER
from ..pilot.run import PilotRun, PilotSpec
from ..pool.catalog import DatasetRef, total_bytes
from ..pool.manager import PoolManager
from ..pool.pool import Lease
from ..provision import (
    LifetimeClass,
    NegotiationError,
    Offer,
    ProvisioningService,
    StorageSession,
    StorageSpec,
)
from ..runtime.fault import FaultInjector, HeartbeatMonitor
from .dispatch import DispatchQueue
from .engine import SimEngine
from .policies import FIFOPolicy, PreemptionPolicy, QueuePolicy, VictimView


class JobState(enum.Enum):
    QUEUED = "queued"
    ALLOCATED = "allocated"
    PROVISIONING = "provisioning"
    STAGING_IN = "staging_in"
    RUNNING = "running"
    STAGING_OUT = "staging_out"
    TEARDOWN = "teardown"
    DONE = "done"
    FAILED = "failed"


TERMINAL_STATES = frozenset({JobState.DONE, JobState.FAILED})

# The FaultInjector phase names, consulted at the end of PROVISIONING /
# STAGING_IN / RUNNING / STAGING_OUT (see the per-phase _*_done handlers).


@dataclasses.dataclass(frozen=True)
class WorkflowSpec:
    """One job's demands on the provisioning pipeline.

    Storage demands are best stated as a declarative ``storage_spec``
    (:class:`~repro.provision.StorageSpec`): preferred data managers with
    fallbacks, lifetime class, datasets, QoS. The legacy fields
    (``storage=StorageRequest(...)``, ``use_pool``, ``datasets``) remain
    supported and are translated into an equivalent spec pinned to the
    ``ephemeralfs`` backend — they cannot be mixed with ``storage_spec``.
    """

    name: str
    n_compute: int
    storage: Optional[StorageRequest] = None
    stage_in_bytes: float = 0.0
    stage_out_bytes: float = 0.0
    run_time_s: float = 60.0
    n_streams: int = 8
    max_retries: int = 2
    runtime: str = "shifter"
    datasets: tuple = ()              # tuple[DatasetRef, ...] shared inputs
    use_pool: bool = False
    storage_spec: Optional[StorageSpec] = None
    #: commit run progress every this many seconds of RUNNING (None: a fault
    #: at `run` replays the whole run — the pre-checkpointing behavior)
    checkpoint_every_s: Optional[float] = None
    #: modeled size of one checkpoint write, charged against the session's
    #: bandwidth at every commit (and re-read on a cold resume)
    checkpoint_bytes: float = 0.0
    #: preemption rank: a blocked arrival with higher priority may
    #: checkpoint-and-release lower-priority RUNNING jobs (see preempt())
    priority: int = 0
    preemptible: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "datasets", tuple(self.datasets))
        if self.run_time_s < 0 or self.stage_in_bytes < 0 or self.stage_out_bytes < 0:
            raise ValueError(f"negative duration/bytes in spec {self.name!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.checkpoint_every_s is not None and self.checkpoint_every_s <= 0:
            raise ValueError(f"{self.name!r}: checkpoint_every_s must be positive")
        if self.checkpoint_bytes < 0:
            raise ValueError(f"{self.name!r}: negative checkpoint_bytes")
        if self.checkpoint_bytes and self.checkpoint_every_s is None:
            raise ValueError(
                f"{self.name!r}: checkpoint_bytes without checkpoint_every_s "
                "would never be written; set a cadence"
            )
        if self.storage_spec is not None:
            if (
                self.storage is not None
                or self.use_pool
                or self.datasets
                or self.stage_in_bytes
                or self.stage_out_bytes
                or self.n_streams != 8
                or self.runtime != "shifter"
            ):
                raise ValueError(
                    f"{self.name!r}: storage_spec replaces the legacy storage/"
                    "use_pool/datasets/stage_*_bytes/n_streams/runtime fields "
                    "(they all belong on the StorageSpec); set one or the other"
                )
            return
        if any(not isinstance(d, DatasetRef) for d in self.datasets):
            raise ValueError(f"{self.name!r}: datasets must be DatasetRef instances")
        if len({d.name for d in self.datasets}) != len(self.datasets):
            raise ValueError(f"{self.name!r}: duplicate dataset names")
        if self.use_pool and self.storage is not None:
            raise ValueError(
                f"{self.name!r}: use_pool jobs lease pool capacity; "
                "drop the per-job storage request"
            )
        if (
            self.storage is None
            and not self.use_pool
            and (self.stage_in_bytes or self.stage_out_bytes or self.datasets)
        ):
            raise ValueError(f"{self.name!r}: staging bytes without a storage request")

    # -- the one storage path -------------------------------------------------
    def session_spec(self) -> Optional[StorageSpec]:
        """The declarative spec this job presents to the ProvisioningService
        (None for jobs with no storage demand at all). Legacy fields pin the
        ``ephemeralfs`` backend, preserving their original semantics."""
        if self.storage_spec is not None:
            return self.storage_spec
        if self.use_pool:
            return StorageSpec(
                name=self.name,
                lifetime=LifetimeClass.POOLED,
                managers=("ephemeralfs",),
                datasets=self.datasets,
                stage_in_bytes=self.stage_in_bytes,
                stage_out_bytes=self.stage_out_bytes,
                n_streams=self.n_streams,
                runtime=self.runtime,  # type: ignore[arg-type]
            )
        if self.storage is not None:
            return StorageSpec(
                name=self.name,
                nodes=self.storage.nodes,
                capacity_bytes=self.storage.capacity_bytes,
                bandwidth=self.storage.capability_bw,
                managers=("ephemeralfs",),
                datasets=self.datasets,
                stage_in_bytes=self.stage_in_bytes,
                stage_out_bytes=self.stage_out_bytes,
                n_streams=self.n_streams,
                runtime=self.runtime,  # type: ignore[arg-type]
            )
        return None

    @property
    def fault_tolerant(self) -> bool:
        """Checkpoint-aware requeue on: RUNNING commits progress on the
        ``checkpoint_every_s`` cadence and faulted/preempted attempts
        resume from the last committed step instead of restarting."""
        return self.checkpoint_every_s is not None

    @property
    def wants_pool(self) -> bool:
        return self.use_pool or (
            self.storage_spec is not None
            and self.storage_spec.lifetime is LifetimeClass.POOLED
        )

    @property
    def all_datasets(self) -> tuple:
        if self.storage_spec is not None:
            return self.storage_spec.datasets
        return self.datasets

    @property
    def dataset_bytes(self) -> float:
        return total_bytes(self.all_datasets)

    @property
    def scratch_bytes(self) -> float:
        """Private pool capacity a lease must reserve on top of datasets."""
        if self.storage_spec is not None:
            return self.storage_spec.scratch_bytes
        return self.stage_in_bytes + self.stage_out_bytes


@dataclasses.dataclass(slots=True)
class JobRecord:
    """Mutable per-job bookkeeping the orchestrator and metrics share."""

    spec: WorkflowSpec
    job_id: int
    submit_time: float
    state: JobState = JobState.QUEUED
    attempt: int = 0
    sspec: Optional[StorageSpec] = None          # resolved once at submit
    offer: Optional[Offer] = None                # cached non-POOLED negotiation
    session: Optional[StorageSession] = None     # live negotiated grant
    allocation: Optional[Allocation] = None
    alloc_started: Optional[float] = None
    fs_model: Optional[FSDeployment] = None
    failure_phase: Optional[str] = None
    backend: Optional[str] = None                # negotiated data manager
    # storage nodes holding a fully-deployed tree of this job's FS: a retry
    # landing on these nodes redeploys warm (paper §IV-B1)
    warm_nodes: frozenset = frozenset()
    history: list[tuple[JobState, float]] = dataclasses.field(default_factory=list)
    # closed (alloc_time, release_time, n_storage_nodes) intervals per attempt
    storage_intervals: list[tuple[float, float, int]] = dataclasses.field(
        default_factory=list
    )
    staged_in_bytes: float = 0.0
    staged_out_bytes: float = 0.0
    # pool-backed bookkeeping (summed across retries)
    lease: Optional[Lease] = None
    pool_id: Optional[int] = None
    dataset_hits: int = 0
    dataset_misses: int = 0
    stage_in_saved_bytes: float = 0.0
    #: mirrors ``spec.wants_pool`` (checked on every transition; precomputed)
    wants_pool: bool = False
    #: granted (compute ids, storage ids, pool id) per attempt — the
    #: determinism regressions compare these across dispatch paths
    alloc_history: list = dataclasses.field(default_factory=list)
    # -- fault tolerance (checkpoint-aware requeue + preemption) -----------
    committed_run_s: float = 0.0      # run progress durable across attempts
    checkpoints_committed: int = 0
    preemptions: int = 0              # checkpoint-and-release requeues
    resume_attempts: int = 0          # attempts that started with committed work
    run_s_saved: float = 0.0          # run seconds resumes did not replay
    #: storage nodes still holding this job's fully staged inputs (and
    #: checkpoints) from a completed stage-in — a resume landing entirely
    #: on them skips stage-in (the data-plane analogue of ``warm_nodes``)
    staged_nodes: frozenset = frozenset()
    #: bottom-level pilot runtime (two-level scheduling) — None for plain
    #: jobs; every pilot-only hot-path branch gates on this being set
    pilot: Optional[PilotRun] = None
    #: pool still holding this job's latest checkpoint commit (pool ids are
    #: never reused): a pooled resume re-leasing this exact pool skips the
    #: global-FS restore read; cleared when a node loss hits the pool
    checkpoint_pool_id: Optional[int] = None
    run_token: int = 0                # invalidates in-flight run events
    #: invalidates in-flight provision/stage/teardown events — bumped on
    #: every release and on a mid-phase re-price (node-loss degradation)
    phase_token: int = 0
    _phase_end: float = 0.0           # scheduled end of the in-flight stage phase
    _run_base: float = 0.0            # progress committed at segment start
    _run_t0: float = 0.0              # virtual time current segment began
    _run_seg_s: float = 0.0           # progress length of current segment
    _preempt_pending: bool = False    # final checkpoint draining pre-release
    _request: Optional[JobRequest] = None
    _gating: Optional[tuple] = None              # dispatch pre-filter cache

    @property
    def request(self) -> JobRequest:
        """Scheduler-level view of the job's demand (policies rank by it).
        Pool-backed jobs draw storage from a lease, not the allocator.
        Cached: ``sspec`` is resolved once at submit and never changes."""
        if self._request is None:
            storage = None
            if self.sspec is not None and self.sspec.lifetime is not LifetimeClass.POOLED:
                storage = self.sspec.to_request()
            self._request = JobRequest(
                self.spec.name, self.spec.n_compute, storage=storage
            )
        return self._request

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES


@dataclasses.dataclass(frozen=True)
class Reservation:
    """EASY guarantee for a blocked head-of-queue job: its resolved node
    demand and the promised start instant. ``start_at`` is None when no
    start can be proven (needed nodes are held by allocations with no
    release projection) — then nothing backfills at all."""

    job_id: int
    n_compute: int
    n_storage: int
    start_at: Optional[float]


@dataclasses.dataclass(slots=True)
class LiveCounters:
    """Campaign rollups maintained incrementally on every transition and
    release, so mid-flight dashboard polls are O(1) instead of the O(jobs)
    re-scan `metrics.summarize` pays (the batch path remains the reference;
    `tests/test_fault_tolerance.py` holds the two equal).

    Open storage allocations are folded as two aggregates — node count and
    node-weighted start-time sums — so busy node-seconds at any instant is
    ``busy_node_s + now * open_nodes - open_node_start_s`` without walking
    live jobs."""

    n_jobs: int = 0
    n_done: int = 0
    n_failed: int = 0
    retries: int = 0              # fault requeues (preemptions counted apart)
    preemptions: int = 0
    resumes: int = 0              # attempts that started with committed work
    checkpoints: int = 0
    run_s_saved: float = 0.0
    staged_in_bytes: float = 0.0
    staged_out_bytes: float = 0.0
    stage_in_saved_bytes: float = 0.0
    # pilot (two-level scheduling) rollups — task batches fold in O(1)
    pilots: int = 0
    tasks_submitted: int = 0
    tasks_done: int = 0
    tasks_failed: int = 0
    task_retries: int = 0
    busy_node_s: float = 0.0      # closed storage-allocation intervals
    open_nodes: int = 0           # sum of n_storage over open allocations
    open_node_start_s: float = 0.0
    t_first_submit: Optional[float] = None
    t_last_event: float = 0.0

    def note_submit(self, t: float) -> None:
        if self.t_first_submit is None or t < self.t_first_submit:
            self.t_first_submit = t

    def busy_node_seconds(self, now: float) -> float:
        return self.busy_node_s + now * self.open_nodes - self.open_node_start_s

    def makespan_s(self, now: float) -> float:
        if self.t_first_submit is None:
            return 0.0
        return max(self.t_last_event, now) - self.t_first_submit

    def utilization(self, n_storage_nodes: int, now: float) -> float:
        span = self.makespan_s(now)
        if n_storage_nodes <= 0 or span <= 0:
            return 0.0
        return self.busy_node_seconds(now) / (n_storage_nodes * span)


class Orchestrator:
    """Runs provisioning campaigns: many jobs through one cluster, queued
    by policy, timed by the perfmodel, perturbed by fault injection. All
    storage flows through one `ProvisioningService` (``self.provision``)."""

    def __init__(
        self,
        cluster,
        *,
        policy: QueuePolicy | None = None,
        faults: FaultInjector | None = None,
        engine: SimEngine | None = None,
        globalfs_model: FSDeployment | None = None,
        teardown_time_s: float | None = None,
        provision: ProvisioningService | None = None,
        incremental: Optional[bool] = None,
        record_allocations: bool = True,
        preemption: Optional[PreemptionPolicy] = None,
        recorder=None,
    ):
        self.engine = engine or SimEngine()
        if provision is None:
            provision = ProvisioningService(
                cluster,
                globalfs_model=globalfs_model or dom_lustre(),
                teardown_time_s=0.5 if teardown_time_s is None else teardown_time_s,
                clock=lambda: self.engine.now,
            )
        elif globalfs_model is not None or teardown_time_s is not None:
            raise ValueError(
                "globalfs_model/teardown_time_s are service knobs: configure "
                "them on the ProvisioningService you pass in"
            )
        self.provision = provision
        # sessions price TEARDOWN and staging from the service; mirror its
        # values so the orchestrator attributes never disagree with behavior
        self.teardown_time_s = self.provision.teardown_time_s
        self.globalfs_model = self.provision.globalfs_model
        self.scheduler = self.provision.scheduler
        self.provisioner = self.provision.provisioner
        self.faults = faults or FaultInjector()
        # Incremental (indexed) dispatch is the default for every policy
        # honoring the sort_key contract; custom policies fall back to the
        # legacy sort-everything loop. ``incremental=False`` forces the
        # legacy path (the determinism regressions replay both).
        # per-attempt granted node ids on JobRecord.alloc_history —
        # determinism evidence; disable for campaigns of very wide jobs
        # where retaining every node id would dominate memory
        self._record_allocations = record_allocations
        self._incremental_requested = incremental
        self._dq: Optional[DispatchQueue] = None
        self._queue: list[JobRecord] = []      # legacy-path wait queue
        self.policy = policy or FIFOPolicy()   # setter builds the index
        self.jobs: list[JobRecord] = []
        self._ids = itertools.count(1)
        # pool-reap bookkeeping: #pool-wanting jobs not yet terminal and not
        # holding a lease (maintained on every transition — replaces the old
        # O(jobs) scan per reap event) + pending-reap coalescing by fire time
        self._pool_wait_n = 0
        self._reap_times: set[float] = set()
        # last full-scan "nothing fits" conclusion: (admission state it was
        # drawn under, and — for head-blocking policies — the blocking
        # head's key). Lets arrival dispatches short-circuit in O(1).
        self._noadmit_state: Optional[tuple] = None
        self._noadmit_head_key: Optional[tuple] = None
        # fault-tolerant scheduling layer: automatic victim selection for
        # blocked high-priority arrivals (None: preempt() is manual-only),
        # live RUNNING index, the EASY reservation last booked by a
        # reserving policy's scan, and the O(1) campaign counters
        self._preemption = preemption
        self._running: dict[int, JobRecord] = {}
        self.reservation: Optional[Reservation] = None
        self.counters = LiveCounters()
        # observability: a repro.obs.trace.TraceRecorder wires itself into
        # the engine, the provisioning service, the scheduler, and the pool
        # subsystem here (bind is read-only: it never schedules events or
        # touches job/session state, so traced campaigns replay
        # bit-identically — see tests/test_obs.py)
        # chaos engine: armed by enable_chaos(); chaos-off campaigns keep
        # these falsy and schedule zero extra events
        self._chaos_model = None
        self._chaos_retry = None
        self._down_nodes: set[str] = set()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if self.recorder.enabled:
            self.recorder.bind(self)

    @property
    def alerts(self):
        """The :class:`~repro.obs.alerts.AlertEngine` riding the recorder,
        if one was attached (duck-typed — no obs import on the hot path)."""
        return getattr(self.recorder, "alerts", None)

    @property
    def faults(self) -> FaultInjector:
        return self._faults

    @faults.setter
    def faults(self, faults: FaultInjector) -> None:
        """To change fault behavior mid-setup, assign a new injector here
        (mutating an installed injector's ``spec`` is not supported). Only
        the *stock* fault-free injector is bypassed on the hot path —
        subclasses overriding :meth:`FaultInjector.trip` always get
        consulted, whatever their spec says."""
        self._faults = faults
        self._faults_passive = (
            type(faults) is FaultInjector and not faults.any_faults
        )

    @property
    def policy(self) -> QueuePolicy:
        return self._policy

    @policy.setter
    def policy(self, policy: QueuePolicy) -> None:
        """Swapping the policy re-indexes any waiting jobs (their policy
        keys, buckets, and aging class all belong to the old policy)."""
        use = self._incremental_requested
        if use is None:
            use = getattr(policy, "incremental", False)
        elif use and not getattr(policy, "incremental", False):
            raise ValueError(
                f"policy {policy.name!r} does not implement the "
                "incremental dispatch contract (QueuePolicy.sort_key)"
            )
        queued = self.queue
        self._policy = policy
        self._noadmit_state = None     # conclusions belong to the old policy
        self._noadmit_head_key = None
        if use:
            self._dq = DispatchQueue(policy, self.scheduler)
            for job in queued:
                self._dq.add(job, self.engine.now)
            self._queue = []
        else:
            self._dq = None
            self._queue = list(queued)

    @property
    def queue(self) -> list[JobRecord]:
        """Waiting jobs in arrival order (a snapshot under indexed dispatch)."""
        if self._dq is not None:
            return self._dq.jobs()
        return self._queue

    def _enqueue(self, job: JobRecord) -> None:
        if self._dq is not None:
            self._dq.add(job, self.engine.now)
        else:
            self._queue.append(job)

    # -- pools ----------------------------------------------------------------
    @property
    def pools(self) -> Optional[PoolManager]:
        """The service's pool subsystem (None until attached/first use)."""
        return self.provision.pool_manager

    def enable_pools(self, **kwargs) -> PoolManager:
        """Attach a persistent-pool subsystem over this orchestrator's
        provisioning service. Pools themselves are best created through the
        service (a PERSISTENT `StorageSpec`); ``use_pool``/POOLED jobs lease
        from them. A no-argument call returns the existing manager."""
        if self.provision.pool_manager is not None and not kwargs:
            return self.provision.pool_manager
        kwargs.setdefault("clock", lambda: self.engine.now)
        return self.provision.ensure_pools(**kwargs)

    # -- submission ----------------------------------------------------------
    def _check_spec(self, spec: WorkflowSpec) -> None:
        if spec.wants_pool and self.provision.pool_manager is None:
            raise ValueError(
                f"{spec.name!r}: pooled storage requires enable_pools() (or a "
                "PERSISTENT session) first"
            )

    def _make_job(self, spec: WorkflowSpec, at: Optional[float]) -> JobRecord:
        t = self.engine.now if at is None else at
        sspec = spec.session_spec()
        if sspec is None:
            # no storage demand: a dry-run session still co-allocates compute
            sspec = StorageSpec(name=spec.name, managers=("null",))
        job = JobRecord(
            spec=spec,
            job_id=next(self._ids),
            submit_time=t,
            sspec=sspec,
            wants_pool=spec.wants_pool,
        )
        self.jobs.append(job)
        self._pool_wait_n += self._pool_waiting(job)
        self.counters.n_jobs += 1
        self.counters.note_submit(t)
        return job

    def submit(self, spec: WorkflowSpec, at: Optional[float] = None) -> JobRecord:
        """Enqueue a job at virtual time ``at`` (default: now)."""
        self._check_spec(spec)
        job = self._make_job(spec, at)
        self.engine.at(job.submit_time, lambda: self._arrive(job))
        return job

    def submit_pilot(
        self,
        pspec: PilotSpec,
        tasks: tuple = (),
        at: Optional[float] = None,
    ) -> JobRecord:
        """Submit a pilot: ONE top-level job that acquires a block of
        ``n_compute`` compute nodes plus ONE pooled storage session, then
        multiplexes ``tasks`` (sub-node :class:`~repro.pilot.TaskSpec`
        instances) into its ``n_compute * slots_per_node`` slots with the
        in-pilot :class:`~repro.pilot.TaskScheduler`.

        The pilot flows through the ordinary queue/dispatch/negotiation
        path — exactly one negotiation and one ``open_session`` grant per
        attempt, leases from the `PoolManager` so the pilot-wide datasets
        stay warm across the whole task stream — but its RUNNING phase is
        driven by the task scheduler instead of ``run_time_s``: the engine
        sees one coalesced event per completion *batch*, and task-level
        faults/checkpoints requeue inside the pilot without touching the
        global scheduler. Requires :meth:`enable_pools` (the session is
        POOLED). Pilots are not preemptible; the job-level ``run`` fault
        still applies to the whole attempt. Task-level faults consult the
        injector's ``"task"`` phase — arm them *before* submitting (a pilot
        submitted while the injector is passive skips the per-task oracle
        call entirely, the hot-path fast lane).
        """
        spec = WorkflowSpec(
            name=pspec.name,
            n_compute=pspec.n_compute,
            run_time_s=0.0,
            max_retries=pspec.max_retries,
            preemptible=False,
            storage_spec=StorageSpec(
                name=pspec.name,
                lifetime=LifetimeClass.POOLED,
                managers=("ephemeralfs",),
                datasets=tuple(pspec.datasets),
                stage_in_bytes=pspec.stage_in_bytes,
                stage_out_bytes=pspec.stage_out_bytes,
                n_streams=pspec.n_streams,
            ),
        )
        self._check_spec(spec)
        job = self._make_job(spec, at)
        if self._faults_passive:
            trip = None
        else:
            def trip(name: str) -> bool:
                return self.faults.trip(name, "task")
        pilot = PilotRun(
            pspec,
            engine=self.engine,
            recorder=self.recorder,
            counters=self.counters,
            trip=trip,
            job_id=job.job_id,
        )
        job.pilot = pilot
        self.counters.pilots += 1
        for t in tasks:
            if isinstance(t, tuple):
                tspec, n = t
                pilot.submit(tspec, n)
            else:
                pilot.submit(t)
        self.engine.at(job.submit_time, lambda: self._arrive(job))
        return job

    def _arrive(self, job: JobRecord) -> None:
        feasible = job.spec.n_compute <= len(self.scheduler.cluster.compute_nodes)
        if feasible:
            try:
                offer = self.provision.negotiate(job.sspec)
            except NegotiationError:
                # an arrival mid-outage queues anyway: the verdict may be
                # an artifact of a healing pool, and the post-repair
                # dispatch re-derives it from whole-cluster state
                feasible = bool(self._down_nodes)
            else:
                if job.sspec.lifetime is not LifetimeClass.POOLED:
                    job.offer = offer   # static over the campaign: reuse at dispatch
        if not feasible:
            # No backend can ever serve this spec on this cluster: fail fast
            # instead of letting an error escape the campaign (or queueing
            # forever).
            job.failure_phase = "infeasible"
            self._transition(job, JobState.QUEUED)
            self._transition(job, JobState.FAILED)
            return
        self._transition(job, JobState.QUEUED)
        self._enqueue(job)
        self._dispatch(new_job=job)
        if (
            self._preemption is not None
            and job.state is JobState.QUEUED
            and job.spec.priority > 0
        ):
            self._try_preempt(job)

    # -- dispatch loop -------------------------------------------------------
    def _dispatch(self, new_job: Optional[JobRecord] = None) -> None:
        """Start every queued job the policy admits against the free pool.
        ``new_job`` marks an arrival-triggered dispatch, which the indexed
        path can often resolve in O(1) (nothing freed since the last scan
        concluded nothing fits, so only the arrival itself is a candidate)."""
        if self._dq is not None:
            self._dispatch_indexed(new_job)
        else:
            self._dispatch_legacy()

    # admission state = everything a refusal can go stale against: the
    # scheduler free pool (epoch) and the pool subsystem (leases, ledgers,
    # catalog). Aging/promotion changes *order*, never admissibility.
    def _admission_state(self) -> tuple:
        pm = self.provision.pool_manager
        return (self.scheduler.epoch, pm.epoch if pm is not None else -1)

    def _sizing_signature(self) -> tuple:
        """Weakest-free-node contributions: while these are unchanged, every
        capacity/bandwidth request resolves to the same node count, so a
        shrinking free pool can only turn fits into misfits — refusals from
        earlier in the scan stay valid."""
        s = self.scheduler
        return (s.free_min_capacity(), s.free_min_bandwidth())

    _ADMITTED, _REFUSED, _FAILED = "admitted", "refused", "failed"

    def _probe(self, job: JobRecord, reservation: Optional[Reservation] = None) -> str:
        """One admission attempt against the live cluster (indexed path).
        With a ``reservation``, admission runs under the EASY no-delay
        proof instead of the plain open (and skips the pre-filter: the
        proof does its own fit checks)."""
        if reservation is None and not self._admittable_now(job):
            return self._REFUSED
        try:
            session = (
                self._try_open(job)
                if reservation is None
                else self._reserved_try_open(job, reservation)
            )
        except NegotiationError:
            if self._down_nodes:
                # mid-outage the conclusion is not trustworthy: the pool
                # that could hold this working set may be healing. Wait —
                # the repair/backfill re-dispatch will probe again.
                return self._REFUSED
            self._dq.remove(job)
            job.failure_phase = "infeasible"
            self._transition(job, JobState.FAILED)
            return self._FAILED
        if session is None:
            return self._REFUSED
        self._dq.remove(job)
        self._start(job, session)
        return self._ADMITTED

    # -- EASY reservations ----------------------------------------------------
    def _reserve(self, job: JobRecord) -> Reservation:
        """Book the blocked head its start time: the earliest instant the
        scheduler's projected-release ledger says its node demand fits."""
        try:
            hc, hs = self.scheduler.demand(job.request)
        except AllocationError:
            return Reservation(job.job_id, 0, 0, None)
        t = self.scheduler.earliest_fit(hc, hs, self.engine.now)
        rec = self.recorder
        if rec.enabled:
            rec.reservation(job.job_id, t)
        return Reservation(job.job_id, hc, hs, t)

    def _reserved_try_open(
        self, job: JobRecord, res: Reservation
    ) -> Optional[StorageSession]:
        """Grant a backfill candidate only when it provably cannot delay the
        reserved head start: either the head's node counts survive at
        ``start_at`` even if this candidate never releases, or the
        candidate's own modeled completion lands before the reservation
        (checked against the live session costs — the grant is handed back
        when the proof fails). An unprovable reservation backfills nothing."""
        if res.start_at is None:
            return None
        sched = self.scheduler
        try:
            cc, cs = sched.demand(job.request)
        except AllocationError:
            return None
        fc, fs = sched.free_counts()
        if cc > fc or cs > fs:
            return None                  # does not even fit right now
        dc, ds = sched.projected_free_at(res.start_at)
        if fc - cc + dc >= res.n_compute and fs - cs + ds >= res.n_storage:
            return self._try_open(job)   # leaves the head whole regardless
        if job.sspec.lifetime is not LifetimeClass.EPHEMERAL:
            # proving completion-before-reservation needs a trial grant,
            # and opening a POOLED/PERSISTENT session mutates pool state
            # (pins, evictions, pool creation): refuse instead of probing
            return None
        session = self._try_open(job)
        if session is None:
            return None
        if self.engine.now + self._session_span_s(job, session) <= res.start_at:
            return session
        session.release(self.engine.now)   # would delay the head: hand it back
        # the trial grant never ran: un-count it so session telemetry keeps
        # meaning "sessions that actually carried a job attempt"
        stats = self.provision.stats
        stats.sessions_opened[session.backend] -= 1
        stats.sessions_released -= 1
        return None

    def _dispatch_indexed(self, new_job: Optional[JobRecord] = None) -> None:
        """Incremental dispatch over the indexed queue.

        Observably identical to :meth:`_dispatch_legacy`: same-signature
        jobs receive identical admission answers at any instant, so probing
        one head per bucket probes exactly the jobs whose refusal the legacy
        scan would not have skipped; and a candidate heap merged with each
        admitted bucket's next head reproduces the legacy restart order as
        long as no admission changed the sizing or pool state (when one
        does, the pass restarts from a fresh ranking, as legacy always
        does)."""
        dq = self._dq
        now = self.engine.now
        dq.promote(now)
        state = self._admission_state()
        # reserving policies re-scan on every trigger: a lone-arrival probe
        # would bypass the reservation's no-delay gating, and backfill
        # verdicts also depend on projected completions, which the
        # admission state deliberately does not track
        if (
            new_job is not None
            and self._noadmit_state == state
            and not self.policy.reserving
        ):
            # Nothing has been freed since a full scan concluded that
            # nothing fits: the arrival is the only new candidate.
            policy = self.policy
            if policy.head_blocking:
                blocked = self._noadmit_head_key
                if blocked is not None:
                    key_new = (
                        policy.sort_key(new_job, self.scheduler, now),
                        dq.seq_of(new_job),
                    )
                    if key_new >= blocked:
                        return          # the blocked head still blocks
            else:
                if not dq.is_bucket_head(new_job):
                    return              # same-signature job already refused
                sizing = self._sizing_signature()
                if self._probe(new_job) is not self._ADMITTED:
                    return              # state unchanged; refusals still hold
                if (
                    self._sizing_signature() == sizing
                    and self._admission_state()[1] == state[1]
                ):
                    # the admission only shrank the free pool: every earlier
                    # refusal still holds, no full scan needed
                    self._noadmit_state = self._admission_state()
                    return
        self._run_dispatch_scan(now)

    def _run_dispatch_scan(self, now: float) -> None:
        """One dispatch pass over the bucket heads, merged in policy order.

        Head-blocking policies must probe their true first head, so they
        skip the admissibility gate and stop at the first refusal; all
        others gate out certain refusals before paying for policy keys and
        keep scanning. Either way, an admitted (or failed) bucket's next
        head re-enters the heap exactly where the departing job ranked —
        the legacy restart order — as long as no admission moved the
        sizing or pool state (then the pass restarts from a fresh ranking,
        as legacy always does)."""
        dq = self._dq
        head_blocking = self.policy.head_blocking
        reserving = self.policy.reserving
        # reserving policies must see their true first head (the job the
        # reservation belongs to), so they skip the gate like head-blockers
        gate = None if (head_blocking or reserving) else self._admittable_now
        while True:
            reservation = None
            if reserving:
                self.reservation = None
            candidates = dq.candidate_heads(now, gate)
            if not candidates:
                self._noadmit_state = self._admission_state()
                self._noadmit_head_key = None
                return
            heapq.heapify(candidates)
            sizing = self._sizing_signature()
            pool_epoch = self._admission_state()[1]
            restart = False
            while candidates:
                key, seq, job, bucket = heapq.heappop(candidates)
                outcome = self._probe(job, reservation)
                if outcome is self._REFUSED:
                    if head_blocking:
                        self._noadmit_state = self._admission_state()
                        self._noadmit_head_key = (key, seq)
                        return
                    if reserving and reservation is None:
                        # the first refusal in policy order is the queue
                        # head: book its EASY reservation; later candidates
                        # are admitted only under its no-delay proof
                        reservation = self._reserve(job)
                        self.reservation = reservation
                    continue            # whole bucket refused until a restart
                if outcome is self._ADMITTED and (
                    self._sizing_signature() != sizing
                    or self._admission_state()[1] != pool_epoch
                ):
                    restart = True      # refusals/ranks may have gone stale
                    break
                item = dq.head_item(bucket, now, gate)
                if item is not None:
                    heapq.heappush(candidates, item)
            if restart:
                continue
            self._noadmit_state = self._admission_state()
            self._noadmit_head_key = None
            return

    def _dispatch_legacy(self) -> None:
        """The pre-index dispatch loop (compatibility fallback for custom
        policies, and the reference the determinism regressions replay).
        Reserving policies get the same EASY gating as the indexed path:
        the pass's first refusal books the reservation, and the rest of the
        pass may only backfill around it (each admission restarts the pass,
        so the reservation is re-derived from fresh state)."""
        started = True
        reserving = self.policy.reserving
        while started and self._queue:
            started = False
            reservation = None
            if reserving:
                self.reservation = None
            for job in self.policy.order(self._queue, self.scheduler, self.engine.now):
                try:
                    if reservation is not None:
                        session = self._reserved_try_open(job, reservation)
                    else:
                        session = self._try_open(job)
                except NegotiationError:
                    if self._down_nodes:
                        # mid-outage infeasibility is not trustworthy (the
                        # capable pool may be healing): keep the job queued
                        # and let the repair/backfill re-dispatch re-probe
                        if self.policy.head_blocking:
                            break
                        continue
                    # what was feasible at arrival no longer is (e.g. every
                    # pool that could hold the working set was retired):
                    # fail fast instead of stranding the job in the queue
                    self._queue.remove(job)
                    job.failure_phase = "infeasible"
                    self._transition(job, JobState.FAILED)
                    started = True
                    break
                if session is None:
                    if self.policy.head_blocking:
                        break
                    if reserving and reservation is None:
                        reservation = self._reserve(job)
                        self.reservation = reservation
                    continue
                self._queue.remove(job)
                self._start(job, session)
                started = True
                break                 # re-ask the policy: free pool changed

    def _gating(self, job: JobRecord) -> tuple:
        """Pre-filter terms for a job, computed once: ``()`` when the job
        must always be probed for real (POOLED/PERSISTENT specs, custom
        backends), else ``(n_compute, storage_request_or_None)``."""
        gating = job._gating
        if gating is None:
            offer = job.offer
            if offer is None or job.sspec.lifetime is not LifetimeClass.EPHEMERAL:
                gating = ()
            else:
                backend = self.provision.registry.get(offer.backend)
                if backend is None or not backend.scheduler_gated:
                    gating = ()
                else:
                    storage = (
                        job.request.storage
                        if backend.capabilities.dedicated_nodes
                        else None
                    )
                    if storage is not None and storage.nodes is not None:
                        storage = storage.nodes      # static node count
                    gating = (job.spec.n_compute, storage)
            job._gating = gating
        return gating

    def _admittable_now(self, job: JobRecord) -> bool:
        """Cheap pre-filter for indexed dispatch: False only when
        ``_try_open`` is *certain* to return None right now (two O(1) count
        checks against the indexed free pool). Only ``scheduler_gated``
        backends — whose EPHEMERAL admission is exactly the scheduler
        co-allocation fitting — are filtered; POOLED/PERSISTENT specs and
        custom backends always probe for real."""
        gating = self._gating(job)
        if not gating:
            return True
        n_compute, storage = gating
        sched = self.scheduler
        if n_compute > len(sched._free_compute):
            return False
        if storage is None:
            return True
        if type(storage) is int:
            return storage <= len(sched._free_storage)
        return sched.resolve_storage_nodes(storage) <= len(sched._free_storage)

    def _try_open(self, job: JobRecord) -> Optional[StorageSession]:
        """One declarative call grants everything the job holds: compute
        nodes co-allocated with whatever storage the negotiated backend
        needs (nodes + deploy, a pool lease, or nothing). Fault-tolerant
        specs additionally carry their resume state: which nodes still hold
        the staged inputs, and how many checkpoint bytes a cold landing
        must read back (time-cost-only — admission answers are unchanged,
        so resume attempts keep their admission-signature bucket)."""
        sspec = job.sspec
        offer = job.offer
        if offer is None:
            offer = self.provision.negotiate(sspec)   # may raise NegotiationError
            if sspec.lifetime is not LifetimeClass.POOLED:
                # EPHEMERAL/PERSISTENT feasibility is static over a campaign;
                # POOLED offers go stale as pools retire/drain, so those
                # re-negotiate on every dispatch attempt
                job.offer = offer
        ft = job.spec.fault_tolerant
        return self.provision.try_open_session(
            sspec,
            n_compute=job.spec.n_compute,
            warm_nodes=job.warm_nodes,
            now=self.engine.now,
            offer=offer,
            staged_nodes=job.staged_nodes if ft else frozenset(),
            restore_bytes=(
                job.spec.checkpoint_bytes
                if ft and job.committed_run_s > 0
                else 0.0
            ),
            restore_pool_id=job.checkpoint_pool_id if ft else None,
        )

    def _start(self, job: JobRecord, session: StorageSession) -> None:
        job.session = session
        job.allocation = session.allocation
        job.alloc_started = self.engine.now
        job.backend = session.backend
        self._transition(job, JobState.ALLOCATED)
        was_waiting = self._pool_waiting(job)
        job.lease = session.lease
        self._pool_wait_n += self._pool_waiting(job) - was_waiting
        if self._record_allocations:
            alloc = session.allocation
            job.alloc_history.append(
                (
                    tuple(n.node_id for n in alloc.compute_nodes) if alloc else (),
                    tuple(n.node_id for n in alloc.storage_nodes) if alloc else (),
                    session.lease.pool_id if session.lease is not None else None,
                )
            )
        if session.lease is not None:
            job.pool_id = session.lease.pool_id
            job.dataset_hits += session.lease.hits
            job.dataset_misses += session.lease.misses
        job.fs_model = session.fs_model
        if session.allocation is not None:
            n = len(session.allocation.storage_nodes)
            self.counters.open_nodes += n
            self.counters.open_node_start_s += n * self.engine.now
            # feed the EASY reservation ledger: when this attempt should
            # release, from the session's modeled costs (advisory — faults
            # and preemptions release earlier, and the ledger self-corrects)
            pilot = job.pilot
            if pilot is not None and pilot.spec.open_ended:
                # open-ended pilots accept late tasks: they promise no
                # release, so EASY must not book backfill holes against them
                self.scheduler.note_projected_release(session.allocation, None)
            else:
                self.scheduler.note_projected_release(
                    session.allocation,
                    self.engine.now + self._session_span_s(job, session),
                )
        rec = self.recorder
        if rec.enabled:
            rec.grant(job, session)
        self._transition(job, JobState.PROVISIONING)
        eng = self.engine
        token = job.phase_token
        eng.at(
            eng.now + session.provision_time_s,
            lambda: self._provision_done(job, token),
        )

    # -- phase machinery -----------------------------------------------------
    # Each phase-completion callback schedules its successor directly: no
    # per-event state dispatch on the hot path. A fault trip at any phase
    # boundary routes through _fail_attempt (release + requeue-or-FAIL).
    def _trip(self, job: JobRecord, phase: str) -> bool:
        return not self._faults_passive and self.faults.trip(job.spec.name, phase)

    def _provision_done(self, job: JobRecord, token: int = 0) -> None:
        if token != job.phase_token:
            return                       # attempt released mid-phase (chaos)
        if self._trip(job, "provision"):
            self._fail_attempt(job, "provision")
            return
        session = job.session
        if session.lease is None and job.allocation is not None:
            job.warm_nodes = job.warm_nodes | frozenset(
                n.node_id for n in job.allocation.storage_nodes
            )
        self._transition(job, JobState.STAGING_IN)
        eng = self.engine
        end = eng.now + session.stage_in_time_s
        job._phase_end = end
        eng.at(end, lambda: self._stage_in_done(job, token))

    def _stage_in_done(self, job: JobRecord, token: int = 0) -> None:
        if token != job.phase_token:
            return                       # attempt released or re-priced mid-stage
        if self._trip(job, "stage_in"):
            self._fail_attempt(job, "stage_in")
            return
        session = job.session
        counters = self.counters
        job.staged_in_bytes += session.stage_in_bytes
        counters.staged_in_bytes += session.stage_in_bytes
        # saved bytes count only when the stage-in actually completed
        # (a faulted attempt neither staged nor saved anything)
        job.stage_in_saved_bytes += session.saved_bytes
        counters.stage_in_saved_bytes += session.saved_bytes
        # lease misses are now resident: hits for every later job
        session.mark_staged(self.engine.now)
        if (
            job.spec.fault_tolerant
            and session.lease is None
            and job.allocation is not None
        ):
            # these nodes now hold the full staged input set: a resume
            # attempt landing entirely on them skips stage-in
            job.staged_nodes = job.staged_nodes | frozenset(
                n.node_id for n in job.allocation.storage_nodes
            )
        if job.committed_run_s > 0:
            # a resume attempt: the committed steps are run time not replayed
            job.resume_attempts += 1
            job.run_s_saved += job.committed_run_s
            counters.resumes += 1
            counters.run_s_saved += job.committed_run_s
        self._transition(job, JobState.RUNNING)
        if job.pilot is not None:
            self._begin_pilot(job)
        else:
            self._schedule_run(job)

    # -- pilots (two-level scheduling) -----------------------------------------
    def _begin_pilot(self, job: JobRecord) -> None:
        """Hand the RUNNING phase to the pilot's task scheduler. The pilot
        calls back into :meth:`_run_done` (with this attempt's run token)
        when its task stream drains, so STAGING_OUT/TEARDOWN/DONE — and the
        job-level ``run`` fault check — proceed exactly like a plain job."""
        pilot = job.pilot
        session = job.session
        token = job.run_token
        pm = self.provision.pool_manager
        pool_nodes = 0
        if pm is not None and job.pool_id is not None:
            pool_nodes = len(pm.get(job.pool_id).storage_node_ids)

        def reproject() -> None:
            # the pilot's drain estimate moved (late tasks, resize): refresh
            # the EASY ledger so backfill proofs track the new horizon
            s = job.session
            if s is None or s.allocation is None:
                return
            if pilot.spec.open_ended:
                self.scheduler.note_projected_release(s.allocation, None)
                return
            self.scheduler.note_projected_release(
                s.allocation,
                self.engine.now
                + pilot.projected_run_s(s)
                + s.stage_out_time_s
                + s.teardown_time_s,
            )

        pilot.begin(
            session,
            self.engine.now,
            on_complete=lambda: self._run_done(job, token),
            reproject=reproject,
            pool_nodes=pool_nodes,
        )

    def _degrade_pilot(self, job: JobRecord, node_id: str) -> None:
        """A running pilot's pool lost a backing node: degrade through the
        chaos path instead of killing the attempt. Resident tasks requeue
        inside the pilot with their committed checkpoint progress, the slot
        pool shrinks in proportion to the lost backing, and the EASY
        projection stretches. The lease survives — the pilot-wide datasets
        are re-read by requeued task waves, never re-negotiated."""
        now = self.engine.now
        rec = self.recorder
        if rec.enabled:
            rec.degraded(job, node_id, now)
        job.pilot.on_node_down(node_id, now)

    # -- RUNNING phase (checkpoint segments) ----------------------------------
    def _checkpoint_cost(self, job: JobRecord, session=None) -> float:
        b = job.spec.checkpoint_bytes
        if b <= 0:
            return 0.0
        return (session or job.session).checkpoint_write_s(b)

    def _run_wall_s(self, job: JobRecord, session=None) -> float:
        """Modeled wall time the rest of this job's RUNNING phase occupies:
        the uncommitted remainder plus one checkpoint write per full
        ``checkpoint_every_s`` segment inside it. For pilots: the task
        backlog spread over the slot pool, waves' I/O included."""
        if job.pilot is not None:
            return job.pilot.projected_run_s(session or job.session)
        spec = job.spec
        remaining = max(0.0, spec.run_time_s - job.committed_run_s)
        every = spec.checkpoint_every_s
        if every is None or remaining <= every:
            return remaining
        n_commits = math.ceil(remaining / every) - 1
        return remaining + n_commits * self._checkpoint_cost(job, session)

    def _session_span_s(self, job: JobRecord, session: StorageSession) -> float:
        """Grant-to-release wall time for this attempt under the session's
        models — the projection backing the EASY reservation ledger."""
        return (
            session.provision_time_s
            + session.stage_in_time_s
            + self._run_wall_s(job, session)
            + session.stage_out_time_s
            + session.teardown_time_s
        )

    def _schedule_run(self, job: JobRecord) -> None:
        """Schedule the rest of the RUNNING phase. Without checkpointing
        this is the single end-of-run event (bit-for-bit the pre-existing
        behavior); with a cadence, the remainder is cut into
        ``checkpoint_every_s`` progress segments, each closed by a commit
        event that pays the modeled checkpoint write."""
        eng = self.engine
        spec = job.spec
        remaining = max(0.0, spec.run_time_s - job.committed_run_s)
        every = spec.checkpoint_every_s
        token = job.run_token
        job._run_base = job.committed_run_s
        job._run_t0 = eng.now
        if every is None or remaining <= every:
            job._run_seg_s = remaining
            eng.at(eng.now + remaining, lambda: self._run_done(job, token))
            return
        job._run_seg_s = every
        cost = self._checkpoint_cost(job)
        eng.at(eng.now + every + cost, lambda: self._checkpoint_commit(job, token))

    def _checkpoint_commit(self, job: JobRecord, token: int) -> None:
        """One committed step: ``checkpoint_every_s`` of progress plus its
        write are durable — a later fault resumes from here."""
        if token != job.run_token:
            return                       # preempted mid-segment: stale event
        job.committed_run_s = min(
            job.spec.run_time_s, job._run_base + job._run_seg_s
        )
        job.checkpoints_committed += 1
        if job.pool_id is not None and job.spec.checkpoint_bytes > 0:
            # the write landed in the leased pool's warm tree: a resume
            # re-leasing this exact pool skips the global-FS restore read
            job.checkpoint_pool_id = job.pool_id
        self.counters.checkpoints += 1
        rec = self.recorder
        if rec.enabled:
            rec.checkpoint(job)
        self._schedule_run(job)

    def _run_progress(self, job: JobRecord, now: float) -> float:
        """Run seconds completed by ``now``: the committed base plus the
        current segment's elapsed progress (write stalls excluded)."""
        if job.state is not JobState.RUNNING:
            return job.committed_run_s
        return min(
            job.spec.run_time_s,
            job._run_base + min(max(0.0, now - job._run_t0), job._run_seg_s),
        )

    def _run_done(self, job: JobRecord, token: int = 0) -> None:
        if token != job.run_token:
            return                       # preempted mid-run: stale event
        if self._trip(job, "run"):
            self._fail_attempt(job, "run")
            return
        session = job.session
        self._transition(job, JobState.STAGING_OUT)
        eng = self.engine
        ptoken = job.phase_token
        end = eng.now + session.stage_out_time_s
        job._phase_end = end
        eng.at(end, lambda: self._stage_out_done(job, ptoken))

    def _stage_out_done(self, job: JobRecord, token: int = 0) -> None:
        if token != job.phase_token:
            return                       # attempt released or re-priced mid-stage
        if self._trip(job, "stage_out"):
            self._fail_attempt(job, "stage_out")
            return
        session = job.session
        job.staged_out_bytes += session.stage_out_bytes
        self.counters.staged_out_bytes += session.stage_out_bytes
        # pool-backed / always-on backends release for free (the data
        # manager outlives the job); only job-scoped deploys pay teardown
        self._transition(job, JobState.TEARDOWN)
        eng = self.engine
        eng.at(eng.now + session.teardown_time_s, lambda: self._teardown_done(job, token))

    def _teardown_done(self, job: JobRecord, token: int = 0) -> None:
        if token != job.phase_token:
            return                       # attempt released mid-teardown (chaos)
        self._release(job)
        self._transition(job, JobState.DONE)
        self._dispatch()

    def _fail_attempt(self, job: JobRecord, phase: str, *, dispatch: bool = True) -> None:
        # a job with committed checkpoint steps requeues as a *resume*
        # attempt: committed_run_s survives the release, so the next
        # attempt pays only the remainder (and its restore traffic) — see
        # _try_open / _schedule_run. Nothing to do here beyond not wiping it.
        job.failure_phase = phase
        self._release(job)
        job.attempt += 1
        requeued = job.attempt <= job.spec.max_retries
        rec = self.recorder
        if rec.enabled:
            rec.fault(job, phase, requeued)
        if not requeued:
            self._transition(job, JobState.FAILED)
        else:
            self.counters.retries += 1
            self._transition(job, JobState.QUEUED)
            self._enqueue(job)
        if dispatch:
            # a node-down handler fails many attempts in one event and
            # dispatches once at the end, after the pools took their loss
            self._dispatch()

    def _release(self, job: JobRecord) -> None:
        session = job.session
        if session is None:
            return
        rec = self.recorder
        if rec.enabled:
            rec.release(job)
        job.run_token += 1           # any in-flight run event is now stale
        job.phase_token += 1         # ...and any in-flight phase event too
        job._preempt_pending = False # a draining final write died with the attempt
        if job.pilot is not None:
            # requeue the pilot's resident tasks (committed progress kept);
            # a later attempt re-packs the surviving backlog
            job.pilot.suspend(self.engine.now)
        if job.allocation is not None:
            t0 = job.alloc_started if job.alloc_started is not None else self.engine.now
            job.storage_intervals.append(
                (t0, self.engine.now, len(job.allocation.storage_nodes))
            )
            n = len(job.allocation.storage_nodes)
            counters = self.counters
            counters.open_nodes -= n
            counters.open_node_start_s -= n * t0
            counters.busy_node_s += (self.engine.now - t0) * n
        pooled = session.lease is not None
        session.release(self.engine.now)
        job.session = None
        was_waiting = self._pool_waiting(job)
        job.lease = None
        self._pool_wait_n += self._pool_waiting(job) - was_waiting
        job.allocation = None
        job.alloc_started = None
        job.fs_model = None
        if pooled and self.pools is not None and self.pools.ttl_s is not None:
            # coalesce: many leases released at one event time used to fan
            # out into identical reap events; one per fire time suffices
            t = self.engine.now + self.pools.ttl_s
            if t not in self._reap_times:
                self._reap_times.add(t)
                self.engine.at(t, lambda: self._run_reap(t))

    def _run_reap(self, t: float) -> None:
        self._reap_times.discard(t)
        self._reap_pools()

    def _pool_waiting(self, job: JobRecord) -> bool:
        """Is this a pool-wanting job that has yet to run (no lease, not
        terminal)? Counted incrementally in ``_pool_wait_n`` so the TTL
        reaper never scans the whole campaign's job list."""
        return (
            job.wants_pool
            and job.lease is None
            and job.state not in TERMINAL_STATES
        )

    def _reap_pools(self) -> None:
        """TTL check scheduled after lease releases. Never reaps while any
        pool-backed job has yet to run — queued now, requeued after a
        fault, or submitted with a future arrival time — because a reaped
        pool could strand it (or fail it spuriously as infeasible)."""
        if self.pools is None:
            return
        if self._pool_wait_n > 0:
            return
        self.pools.reap_idle(self.engine.now)

    def _transition(self, job: JobRecord, state: JobState) -> None:
        if job.wants_pool:
            was_waiting = self._pool_waiting(job)
            job.state = state
            self._pool_wait_n += self._pool_waiting(job) - was_waiting
        else:
            job.state = state
        job.history.append((state, self.engine.now))
        rec = self.recorder
        if rec.enabled:
            rec.transition(job, state)
        counters = self.counters
        counters.t_last_event = self.engine.now
        if state is JobState.RUNNING:
            self._running[job.job_id] = job
        else:
            self._running.pop(job.job_id, None)
            if state is JobState.DONE:
                counters.n_done += 1
            elif state is JobState.FAILED:
                counters.n_failed += 1

    # -- preemption -----------------------------------------------------------
    def preempt(self, victim: JobRecord) -> bool:
        """Checkpoint-and-release a RUNNING job for a higher-priority
        arrival (or by hand). With checkpointing on, the victim's progress
        commits through a final checkpoint write — it keeps holding its
        nodes for the write's modeled duration, then releases; without
        checkpointing, uncommitted progress is simply lost. Either way the
        victim requeues as a resume attempt that does **not** count against
        ``max_retries`` (an eviction is not a fault). Returns False when
        the job is not RUNNING or is already draining its final checkpoint."""
        if victim.state is not JobState.RUNNING or victim._preempt_pending:
            return False
        now = self.engine.now
        victim.run_token += 1            # cancel the pending run/commit event
        if victim.spec.checkpoint_every_s is not None:
            victim.committed_run_s = self._run_progress(victim, now)
            victim.checkpoints_committed += 1
            if victim.pool_id is not None and victim.spec.checkpoint_bytes > 0:
                victim.checkpoint_pool_id = victim.pool_id
            self.counters.checkpoints += 1
            cost = self._checkpoint_cost(victim)
            if cost > 0:
                victim._preempt_pending = True
                token = victim.run_token
                self.engine.at(
                    now + cost, lambda: self._preempt_release(victim, token)
                )
                return True
        self._preempt_release(victim)
        return True

    def _preempt_release(self, victim: JobRecord, token: Optional[int] = None) -> None:
        if token is not None and token != victim.run_token:
            return      # the attempt died (chaos) while draining its final write
        victim._preempt_pending = False
        victim.preemptions += 1
        self.counters.preemptions += 1
        rec = self.recorder
        if rec.enabled:
            rec.preemption(victim)
        self._release(victim)
        self._transition(victim, JobState.QUEUED)
        self._enqueue(victim)
        self._dispatch()

    def _try_preempt(self, job: JobRecord) -> bool:
        """A blocked high-priority arrival asks the preemption policy for
        RUNNING victims. Chosen victims are preempted in the policy's
        order; the arrival then competes for the freed nodes at the
        dispatch the releases trigger."""
        try:
            demand = self.scheduler.demand(job.request)
        except AllocationError:
            return False
        now = self.engine.now
        candidates = []
        for victim in self._running.values():
            spec = victim.spec
            if not spec.preemptible or spec.priority >= job.spec.priority:
                continue
            if victim._preempt_pending:
                continue
            alloc = victim.allocation
            candidates.append(
                VictimView(
                    job=victim,
                    priority=spec.priority,
                    progress=(
                        self._run_progress(victim, now) / spec.run_time_s
                        if spec.run_time_s > 0
                        else 1.0
                    ),
                    n_compute=len(alloc.compute_nodes) if alloc else 0,
                    n_storage=len(alloc.storage_nodes) if alloc else 0,
                )
            )
        victims = self._preemption.select(
            job, candidates, demand, self.scheduler.free_counts()
        )
        preempted = False
        for victim in victims:
            preempted |= self.preempt(victim)
        return preempted

    # -- chaos (storage-node failure domain) ----------------------------------
    #: FaultInjector phase name for each interruptible job state — the
    #: synthetic fault a node loss injects lands at the phase the attempt
    #: was actually in (ALLOCATED is transient inside _start; TEARDOWN has
    #: nothing left to lose — outputs are already staged out).
    _PHASE_OF_STATE = {
        JobState.PROVISIONING: "provision",
        JobState.STAGING_IN: "stage_in",
        JobState.RUNNING: "run",
        JobState.STAGING_OUT: "stage_out",
    }

    def enable_chaos(self, model, *, retry=None) -> None:
        """Arm a :class:`~repro.chaos.NodeFaultModel` over this campaign.

        Every failure/repair event is bulk-scheduled now (the model is
        finite by construction), so chaos campaigns replay bit-identically
        and a model that can emit nothing — or ``None`` — schedules
        nothing: chaos-off campaigns run the exact pre-chaos event stream.
        ``retry`` (a :class:`~repro.chaos.RetryPolicy`) additionally arms
        pool self-healing: affected pools backfill from free nodes on the
        policy's backoff cadence.
        """
        if model is None or not model.any_faults:
            return
        unknown = set(model.node_ids) - {
            n.node_id for n in self.scheduler.cluster.storage_nodes
        }
        if unknown:
            raise ValueError(
                f"fault model covers unknown storage nodes: {sorted(unknown)}"
            )
        self._chaos_model = model
        self._chaos_retry = retry
        self.engine.at_many(
            (
                ev.t,
                (
                    (lambda nid: lambda: self._node_down(nid))(ev.node_id)
                    if ev.kind == "down"
                    else (lambda nid: lambda: self._node_repair(nid))(ev.node_id)
                ),
            )
            for ev in model.events()
        )

    def _node_down(self, node_id: str) -> None:
        """One storage node died. Park it in the scheduler, revoke the
        locality credits that named it (warm FS trees and staged inputs on
        other nodes survive), then walk the blast radius: mirrored direct
        deployments degrade in place (half bandwidth, in-flight phase
        re-priced), everything else takes a synthetic fault through the
        ordinary checkpoint-resume requeue path — leaseholders before their
        pools, so residency invalidation never sees a pin."""
        if node_id in self._down_nodes:
            return                       # overlapping outage windows: no-op
        self._down_nodes.add(node_id)
        now = self.engine.now
        self.scheduler.mark_node_down(node_id)
        rec = self.recorder
        if rec.enabled:
            rec.node_down(node_id, now)
        pm = self.provision.pool_manager
        blast = resolve_blast_radius(
            node_id,
            sessions=[j.session for j in self.jobs if j.session is not None],
            pools=pm.live_pools if pm is not None else (),
        )
        hit = {id(s) for s in blast.sessions}
        blast_pool_ids = {p.pool_id for p in blast.pools}
        for job in self.jobs:
            if job.done:
                continue
            if node_id in job.warm_nodes:
                job.warm_nodes = job.warm_nodes - {node_id}
            if node_id in job.staged_nodes:
                job.staged_nodes = job.staged_nodes - {node_id}
            if (
                job.checkpoint_pool_id is not None
                and job.checkpoint_pool_id in blast_pool_ids
            ):
                # the loss took a stripe of the resident checkpoint with it:
                # the next resume must restore from the global FS again
                job.checkpoint_pool_id = None
            session = job.session
            if session is None or id(session) not in hit:
                continue
            if session.lease is None and session.can_degrade:
                self._degrade_job(job, node_id)
            elif (
                job.pilot is not None
                and session.lease is not None
                and job.state is JobState.RUNNING
                and pm is not None
                and len(pm.get(job.pool_id).storage_node_ids) >= 2
            ):
                # a RUNNING pilot on a pool that survives the loss degrades
                # (shrunk slots, requeued resident tasks) instead of dying;
                # a pool left with nothing falls through to _fail_attempt
                self._degrade_pilot(job, node_id)
            else:
                phase = self._PHASE_OF_STATE.get(job.state)
                if phase is not None:
                    self._fail_attempt(job, phase, dispatch=False)
        if pm is not None:
            for pool in blast.pools:
                pm.on_node_down(pool, node_id, now)
                if self._chaos_retry is not None:
                    drive_retries(
                        self.engine,
                        self._chaos_retry,
                        f"pool{pool.pool_id}:{node_id}",
                        lambda p=pool: pm.backfill(p, self.engine.now),
                    )
        self._dispatch()

    def _node_repair(self, node_id: str) -> None:
        """The node came back: un-park it (or un-flag it, if a live
        allocation still holds it), re-silver pools that were waiting on
        it, and re-dispatch — the freed capacity may admit queued jobs."""
        if node_id not in self._down_nodes:
            return
        self._down_nodes.discard(node_id)
        now = self.engine.now
        self.scheduler.mark_node_up(node_id)
        pm = self.provision.pool_manager
        if pm is not None:
            pm.on_node_repair(node_id, now)
        for job in self._running.values():
            if job.pilot is not None:
                # a degraded pilot that lost this node widens back
                job.pilot.on_node_repair(node_id, now)
        rec = self.recorder
        if rec.enabled:
            rec.node_repair(node_id, now)
        self._dispatch()

    def _degrade_job(self, job: JobRecord, node_id: str) -> None:
        """A mirrored deployment lost one replica: the attempt survives
        DEGRADED at half effective bandwidth. Phases not yet scheduled
        re-price through the session's degraded multiplier; the in-flight
        one re-prices here — its *remaining* staging work doubles."""
        session = job.session
        session.degrade()
        eng = self.engine
        now = eng.now
        rec = self.recorder
        if rec.enabled:
            rec.degraded(job, node_id, now)
        state = job.state
        if state is JobState.STAGING_IN or state is JobState.STAGING_OUT:
            remaining = max(0.0, job._phase_end - now) * 2.0
            job.phase_token += 1         # the full-bandwidth end event is stale
            token = job.phase_token
            end = now + remaining
            job._phase_end = end
            cb = (
                self._stage_in_done
                if state is JobState.STAGING_IN
                else self._stage_out_done
            )
            eng.at(end, lambda: cb(job, token))
        elif state is JobState.RUNNING:
            self._reprice_run_segment(job)

    def _reprice_run_segment(self, job: JobRecord) -> None:
        """Degraded mid-RUN: compute progress is unharmed, but a pending
        checkpoint commit priced its write at full bandwidth. Re-issue the
        commit at the degraded cost (the whole write re-prices — a
        conservative model for a mid-write loss); the final run event
        carries no storage traffic and needs nothing."""
        spec = job.spec
        every = spec.checkpoint_every_s
        if every is None or job._preempt_pending:
            return                       # no write pending / final drain stands
        if max(0.0, spec.run_time_s - job._run_base) <= every:
            return                       # pending event is the bare _run_done
        eng = self.engine
        job.run_token += 1
        token = job.run_token
        t = job._run_t0 + every + self._checkpoint_cost(job)
        eng.at(max(t, eng.now), lambda: self._checkpoint_commit(job, token))

    # -- monitoring -----------------------------------------------------------
    def heartbeat_monitor(
        self, nodes: Optional[list] = None, *, timeout_s: float = 60.0
    ) -> HeartbeatMonitor:
        """A `HeartbeatMonitor` bound to this orchestrator's **virtual**
        clock (default node set: the cluster's compute inventory). The
        monitor's own default is ``time.monotonic()`` — correct for real
        per-host agents, but mixed with a virtual clock it silently marks
        every node dead (or never dead), so orchestrator-world callers must
        come through here (or pass ``clock=lambda: engine.now`` themselves)."""
        if nodes is None:
            nodes = [n.node_id for n in self.scheduler.cluster.compute_nodes]
        return HeartbeatMonitor(
            list(nodes), timeout_s=timeout_s, clock=lambda: self.engine.now
        )

    def live_report(self, now: Optional[float] = None):
        """O(1) mid-flight campaign snapshot from the incremental counters
        (`metrics.LiveReport`) — what a dashboard polls instead of the
        O(jobs) `metrics.summarize` scan."""
        from .metrics import live_report

        return live_report(
            self.counters,
            n_storage_nodes=len(self.scheduler.cluster.storage_nodes),
            now=self.engine.now if now is None else now,
        )

    # -- campaign driver -----------------------------------------------------
    def run_campaign(
        self,
        specs: Optional[list[WorkflowSpec]] = None,
        *,
        submit_times: Optional[list[float]] = None,
        until: Optional[float] = None,
        max_events: Optional[int] = None,
    ) -> list[JobRecord]:
        """Submit ``specs`` (if given), drain the event loop, return records.

        ``submit_times`` gives each spec its own arrival instant (e.g. from
        :func:`repro.orchestrator.arrivals.poisson_arrivals` or a replayed
        trace) instead of the batch-at-now default; it must match ``specs``
        in length, and no time may predate the engine clock.

        ``max_events`` sets the engine's runaway-loop backstop. The default
        scales with campaign size — ``max(1_000_000, 40 * n_jobs)`` — so a
        50k-job campaign no longer trips the engine's fixed 1M guard; pass
        ``None`` explicitly through :meth:`SimEngine.run` to disable it.

        Submissions are bulk-scheduled (:meth:`SimEngine.at_many`): one
        heapify instead of one heap push per job for batch arrivals.

        Guarantees every job reaches a terminal state (DONE or FAILED) unless
        ``until`` cut the clock short.
        """
        specs = specs or []
        if submit_times is not None and len(submit_times) != len(specs):
            raise ValueError(
                f"{len(submit_times)} submit times for {len(specs)} specs"
            )
        for spec in specs:
            self._check_spec(spec)
        events = []
        for i, spec in enumerate(specs):
            job = self._make_job(
                spec, None if submit_times is None else submit_times[i]
            )
            events.append(
                (job.submit_time, (lambda j: lambda: self._arrive(j))(job))
            )
        self.engine.at_many(events)
        if max_events is None:
            max_events = max(1_000_000, 40 * len(self.jobs))
        self.engine.run(until=until, max_events=max_events)
        return list(self.jobs)
