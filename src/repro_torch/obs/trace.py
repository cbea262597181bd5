"""Trace recorder: the event bus every hot layer emits into.

This module is the *only* observability surface the hot loops are allowed
to touch (``tools/check_obs_imports.py`` enforces it): it imports nothing
from the rest of ``repro``, so engine/lifecycle/provision/pool/scheduler
can depend on it without cycles or import-time cost.

Two implementations share one duck-typed interface:

* :class:`NullRecorder` — the default. ``enabled`` is ``False`` at class
  level, every method is a no-op, and every call site guards with
  ``if rec.enabled:`` so the off path costs one attribute read. The
  module-level :data:`NULL_RECORDER` singleton is what components hold
  when no tracing was requested.
* :class:`TraceRecorder` — records typed spans and events keyed on the
  **virtual** clock. It is strictly read-only with respect to engine
  state: it never schedules events, never mutates jobs/sessions/pools,
  and stamps time itself through a bound clock — so a campaign replayed
  with the recorder on produces bit-identical ``JobRecord.history``
  (``tests/test_obs.py`` holds this).

The recorder is a *flight recorder*: the highest-frequency hook
(:meth:`TraceRecorder.transition`, ~8 calls per job) only appends one
raw tuple to a list. Building per-job phase spans, job metadata, and the
per-phase duration histograms is deferred to :meth:`_materialize`, which
runs on first access to :attr:`spans` / :attr:`job_meta` (or any export
or report built on them) and is incremental — a live dashboard can read
mid-campaign and the recorder keeps appending after. This is what keeps
tracing-on throughput within the ``benchmarks/obs_bench.py`` overhead
bound.

Wiring is one call: ``TraceRecorder(...).bind(orch)`` (done automatically
by ``Orchestrator(recorder=...)``) installs the recorder on the engine,
the provisioning service, the scheduler, the pool manager and its
evictor, and registers the default time-series probes when a
:class:`~repro.obs.metrics.MetricsHub` is attached.

What gets recorded, per layer:

* lifecycle — every state transition (closed into per-phase spans),
  grants (with the release that *enabled* them, when one landed at the
  same instant — the causal edge the critical-path profiler walks),
  faults/requeues, checkpoint commits, preemptions, EASY reservations.
* provisioning — real negotiations with per-backend rejection reasons;
  offer-cache hits are counted, not evented (a 50k-job campaign would
  otherwise drown the trace in identical records).
* pools — pool create/retire/teardown, lease attach (with dataset
  hits/misses) and release, per-victim evictions.
* scheduler — grant/release counters (the per-job detail already rides
  on the lifecycle events; pools' node allocations are counted here too).
* engine — periodic heap-depth samples (every 512 events) that double as
  the metronome for time-driven metrics sampling.
"""

from __future__ import annotations

from typing import Callable, Optional


class NullRecorder:
    """Do-nothing recorder: the default wired into every component.

    ``enabled`` is a class attribute so the hot-path guard
    ``if rec.enabled:`` is a plain attribute load. The methods exist so
    un-guarded (cold-path) call sites still work against either
    implementation.
    """

    enabled = False
    #: no active layer either — ``Orchestrator.alerts`` reads this
    alerts = None
    __slots__ = ()

    def bind(self, orch) -> "NullRecorder":
        return self

    def bind_engine(self, engine, service=None) -> "NullRecorder":
        return self

    # lifecycle
    def transition(self, job, state) -> None: ...
    def grant(self, job, session) -> None: ...
    def release(self, job) -> None: ...
    def fault(self, job, phase, requeued) -> None: ...
    def checkpoint(self, job) -> None: ...
    def preemption(self, victim) -> None: ...
    def reservation(self, job_id, start_at) -> None: ...

    # provisioning
    def negotiation(self, spec_name, backend, *, cached, rejections=()) -> None: ...
    def session_opened(self, backend) -> None: ...
    def session_released(self, backend) -> None: ...

    # pools
    def pool_created(self, pool, t) -> None: ...
    def pool_retired(self, pool, t) -> None: ...
    def pool_torn_down(self, pool, t) -> None: ...
    def lease_attached(self, lease, pool, n_hits, n_misses, t) -> None: ...
    def lease_released(self, lease, t) -> None: ...
    def eviction(self, pool_id, dataset_name, nbytes) -> None: ...

    # chaos (node failure domain)
    def node_down(self, node_id, t) -> None: ...
    def node_repair(self, node_id, t) -> None: ...
    def degraded(self, job, node_id, t) -> None: ...
    def rebuild(self, pool, node_id, *, via, t) -> None: ...

    # pilots (two-level scheduling)
    def pilot_started(self, name, job_id, t, *, n_tasks, n_slots, packed) -> None: ...
    def task_batch(
        self, name, job_id, t, *,
        completed, failed, requeued, packed, queued, running, occupancy,
    ) -> None: ...
    def pilot_resized(self, name, job_id, t, *, n_slots, cause, packed) -> None: ...

    # scheduler
    def sched_grant(self, allocation) -> None: ...
    def sched_release(self, allocation) -> None: ...

    # engine
    def engine_sample(self, t, heap_len, events_processed) -> None: ...


#: Shared no-op instance — components default to this, never to ``None``.
NULL_RECORDER = NullRecorder()

#: Phases a terminal transition closes with a zero-length marker instead
#: of opening a new span.
_TERMINAL = ("done", "failed")


class TraceRecorder:
    """Records spans/events from a campaign, keyed on the virtual clock.

    Parameters
    ----------
    metrics:
        Optional :class:`~repro.obs.metrics.MetricsHub`. When attached,
        probes registered by :meth:`bind` are sampled every
        ``sample_every_s`` virtual seconds (driven from the engine's
        periodic ``engine_sample`` metronome — the recorder never
        schedules events itself), and per-phase duration histograms are
        folded in when the trace materializes.
    sample_every_s:
        Virtual-time cadence for probe sampling.
    alerts:
        Optional active layer (duck-typed — an
        :class:`~repro.obs.alerts.AlertEngine`): anything exposing
        ``evaluate(t, trace)``. Evaluated right after each metrics sample
        on the same metronome cadence — alerting never adds engine events,
        and like the recorder itself it must stay read-only so traced
        campaigns replay bit-identically. Requires ``metrics``.
    clock:
        Virtual-time source; :meth:`bind` replaces it with the bound
        engine's clock.
    """

    enabled = True

    def __init__(
        self,
        *,
        metrics=None,
        sample_every_s: float = 60.0,
        alerts=None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if alerts is not None and metrics is None:
            raise ValueError(
                "alerts= needs metrics=: rules read the hub's series and the "
                "engine is evaluated on the metrics sample cadence"
            )
        self.metrics = metrics
        self.alerts = alerts
        self.sample_every_s = sample_every_s
        self._clock: Callable[[], float] = clock or (lambda: 0.0)
        #: flat typed event log: ``(kind, t, label, args-dict)``.
        self.events: list[tuple[str, float, str, dict]] = []
        #: closed storage-session intervals ``(job_id, backend, pool_id, t0, t1)``.
        self.sessions: list[tuple[int, Optional[str], Optional[int], float, float]] = []
        #: job_id -> ``[(t, enabling_job_id | None), ...]`` per grant — the
        #: causal edges the critical-path walk follows out of queue waits.
        self.grant_causes: dict[int, list[tuple[float, Optional[int]]]] = {}
        #: cheap named counters (cache hits, scheduler grants, ...).
        self.counts: dict[str, int] = {}
        # flight-recorder buffer: ``transition`` appends ``(job, state, t)``
        # and nothing else; ``_materialize`` drains it into ``_spans`` /
        # ``_job_meta``. ``_raw_append`` is the pre-bound list method so the
        # hot path is a single call (rebound whenever the buffer is swapped).
        self._raw: list[tuple] = []
        self._raw_append = self._raw.append
        self._spans: dict[int, list[tuple[str, float, float]]] = {}
        self._job_meta: dict[int, dict] = {}
        #: job_id -> (backend, pool_id) from the latest grant, merged into
        #: ``job_meta`` at materialize time (grants must not force one).
        self._job_backend: dict[int, tuple] = {}
        # materialize-time caches: the open-phase entry carries the job's
        # spans list (no per-tuple dict lookup into ``_spans``), enum ->
        # phase-string and per-phase histogram handles are memoized (the
        # enum ``.value`` descriptor and hub lookups are measurable at
        # 50k-job scale)
        self._open_phase: dict[int, tuple[str, float, list]] = {}
        self._state_names: dict = {}
        self._phase_hist: dict = {}
        self._count_keys: dict[tuple, str] = {}
        self._open_sessions: dict[int, tuple[Optional[str], Optional[int], float]] = {}
        self._last_release: tuple[Optional[int], Optional[float]] = (None, None)
        self._last_reservation: Optional[tuple] = None
        self._last_sample: Optional[float] = None

    # -- wiring ---------------------------------------------------------------
    def bind(self, orch) -> "TraceRecorder":
        """Install this recorder across one orchestrator's stack and bind
        the virtual clock. Returns self (chainable)."""
        engine = orch.engine
        # read the engine's clock field directly: the ``now`` property costs
        # a descriptor call per recorded event
        self._clock = lambda: engine._now
        engine.recorder = self
        orch.provision.recorder = self   # propagates: scheduler, pools, evictor
        if self.metrics is not None:
            self._register_probes(orch)
        return self

    def bind_engine(self, engine, service=None) -> "TraceRecorder":
        """Bind to a bare :class:`SimEngine` — for drivers that are not an
        orchestrator (the serving campaign): installs the virtual clock and
        the engine metronome, and optionally hooks a
        :class:`~repro.provision.ProvisioningService` so session/pool/lease
        events land in this trace. Probes are the caller's to register on
        the hub directly. Returns self (chainable)."""
        self._clock = lambda: engine._now
        engine.recorder = self
        if service is not None:
            service.recorder = self
        return self

    def _register_probes(self, orch) -> None:
        hub = self.metrics
        sched = orch.scheduler
        counters = orch.counters
        hub.add_probe("queue_depth", lambda: len(orch.queue))
        hub.add_probe("free_compute_nodes", lambda: len(sched._free_compute))
        hub.add_probe("free_storage_nodes", lambda: len(sched._free_storage))
        hub.add_probe("running_jobs", lambda: len(orch._running))
        hub.add_probe("jobs_done", lambda: counters.n_done)
        hub.add_probe("jobs_failed", lambda: counters.n_failed)
        # healthy fraction of storage capacity — 1.0 the whole campaign
        # unless a chaos model is killing nodes
        hub.add_probe("availability", lambda: sched.healthy_capacity_fraction)

        def pool_occupancy() -> float:
            pm = orch.provision.pool_manager
            return pm.occupancy() if pm is not None else 0.0

        def catalog_hit_rate() -> float:
            pm = orch.provision.pool_manager
            return pm.stats.hit_rate if pm is not None else 0.0

        hub.add_probe("pool_occupancy", pool_occupancy)
        hub.add_probe("catalog_hit_rate", catalog_hit_rate)
        hub.add_probe("tasks_done", lambda: counters.tasks_done)

        def pilot_occupancy() -> float:
            # mean slot occupancy over RUNNING pilots (0.0 when none)
            total = n = 0.0
            for job in orch._running.values():
                if job.pilot is not None:
                    total += job.pilot.tasks.occupancy
                    n += 1
            return total / n if n else 0.0

        hub.add_probe("pilot_occupancy", pilot_occupancy)

    # -- internals ------------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    def count(self, key: str, n: int = 1) -> None:
        c = self.counts
        c[key] = c.get(key, 0) + n

    def _tick(self, t: float) -> None:
        """Drive time-based metric sampling — and alert evaluation — off
        recorded activity. Alerts run on exactly the sample cadence, right
        after the probes, so rules always judge fresh series."""
        hub = self.metrics
        if hub is None:
            return
        last = self._last_sample
        if last is None or t - last >= self.sample_every_s:
            self._last_sample = t
            hub.sample(t)
            alerts = self.alerts
            if alerts is not None:
                alerts.evaluate(t, self)

    # -- materialization ------------------------------------------------------
    @property
    def spans(self) -> dict[int, list[tuple[str, float, float]]]:
        """job_id -> closed ``(phase, t0, t1)`` spans, in time order.
        Terminal markers are zero-length ``("done"/"failed", t, t)``.
        Access materializes any buffered transitions first."""
        self._materialize()
        return self._spans

    @property
    def job_meta(self) -> dict[int, dict]:
        """job_id -> {"name", "submit", "backend", "pool_id", "priority"}.
        Access materializes any buffered transitions first."""
        self._materialize()
        return self._job_meta

    def _materialize(self) -> None:
        """Drain the raw transition buffer into spans/meta/histograms.

        Incremental and idempotent: open phases survive across calls, so a
        mid-campaign read sees every span closed so far and later appends
        keep extending the same structures.
        """
        raw = self._raw
        if raw:
            self._raw = []
            self._raw_append = self._raw.append
            names = self._state_names
            hub = self.metrics
            open_ = self._open_phase
            phase_hist = self._phase_hist
            spans_by_job = self._spans
            meta_by_job = self._job_meta
            for job, state, t in raw:
                jid = job.job_id
                phase = names.get(state)
                if phase is None:
                    phase = names[state] = state.value
                entry = open_.get(jid)
                if entry is not None:
                    prev, t0, spans = entry
                    spans.append((prev, t0, t))
                    if hub is not None:
                        hist = phase_hist.get(prev)
                        if hist is None:
                            hist = phase_hist[prev] = hub.histogram("phase_s/" + prev)
                        hist.observe(t - t0)
                else:
                    spans = spans_by_job.get(jid)
                    if spans is None:
                        spans = spans_by_job[jid] = []
                        spec = job.spec
                        meta_by_job[jid] = {
                            "name": spec.name,
                            "submit": job.submit_time,
                            "priority": spec.priority,
                        }
                if phase in _TERMINAL:
                    open_.pop(jid, None)
                    spans.append((phase, t, t))
                else:
                    open_[jid] = (phase, t, spans)
        if self._job_backend:
            meta_by_job = self._job_meta
            for jid, (backend, pool_id) in self._job_backend.items():
                meta = meta_by_job.get(jid)
                if meta is not None:
                    meta["backend"] = backend
                    if pool_id is not None:
                        meta["pool_id"] = pool_id
            self._job_backend.clear()

    # -- lifecycle ------------------------------------------------------------
    def transition(self, job, state) -> None:
        # hottest hook in the recorder (~8 calls/job): append one tuple,
        # defer everything else to ``_materialize``
        self._raw_append((job, state, self._clock()))

    def grant(self, job, session) -> None:
        t = self._clock()
        jid = job.job_id
        rel_id, rel_t = self._last_release
        cause = rel_id if (rel_t == t and rel_id != jid) else None
        self.grant_causes.setdefault(jid, []).append((t, cause))
        lease = session.lease
        pool_id = lease.pool_id if lease is not None else None
        self._job_backend[jid] = (session.backend, pool_id)
        self._open_sessions[jid] = (session.backend, pool_id, t)
        alloc = session.allocation
        self.events.append(
            (
                "grant",
                t,
                job.spec.name,
                {
                    "job_id": jid,
                    "attempt": job.attempt,
                    "backend": session.backend,
                    "pool_id": pool_id,
                    "n_compute": len(alloc.compute_nodes) if alloc else 0,
                    "n_storage": len(alloc.storage_nodes) if alloc else 0,
                    "enabled_by": cause,
                },
            )
        )

    def release(self, job) -> None:
        t = self._clock()
        jid = job.job_id
        self._last_release = (jid, t)
        open_ = self._open_sessions.pop(jid, None)
        if open_ is not None:
            backend, pool_id, t0 = open_
            self.sessions.append((jid, backend, pool_id, t0, t))

    def fault(self, job, phase, requeued) -> None:
        t = self._clock()
        if requeued:
            self.count("fault.requeued")
        self.events.append(
            (
                "fault",
                t,
                job.spec.name,
                {
                    "job_id": job.job_id,
                    "phase": phase,
                    "requeued": requeued,
                    "attempt": job.attempt,
                },
            )
        )

    def checkpoint(self, job) -> None:
        t = self._clock()
        self.events.append(
            (
                "checkpoint",
                t,
                job.spec.name,
                {
                    "job_id": job.job_id,
                    "committed_run_s": job.committed_run_s,
                    "n": job.checkpoints_committed,
                },
            )
        )

    def preemption(self, victim) -> None:
        t = self._clock()
        self.events.append(
            (
                "preempt",
                t,
                victim.spec.name,
                {
                    "job_id": victim.job_id,
                    "committed_run_s": victim.committed_run_s,
                    "preemptions": victim.preemptions,
                },
            )
        )

    def reservation(self, job_id, start_at) -> None:
        # a reserving policy re-books on every blocked scan; record changes
        key = (job_id, start_at)
        if key == self._last_reservation:
            return
        self._last_reservation = key
        t = self._clock()
        self.events.append(
            ("reservation", t, f"job {job_id}", {"job_id": job_id, "start_at": start_at})
        )

    # -- provisioning ---------------------------------------------------------
    def negotiation(self, spec_name, backend, *, cached, rejections=()) -> None:
        if cached:
            self.count("negotiation.cache_hits")
            return
        t = self._clock()
        self.count("negotiation.scored")
        self.events.append(
            (
                "negotiation",
                t,
                spec_name,
                {
                    "backend": backend,
                    "ok": backend is not None,
                    "rejections": [
                        {"backend": r.backend, "reason": r.reason} for r in rejections
                    ],
                },
            )
        )

    def session_opened(self, backend) -> None:
        self.count(self._count_key("sessions.opened.", backend))

    def session_released(self, backend) -> None:
        self.count(self._count_key("sessions.released.", backend))

    def _count_key(self, prefix: str, backend) -> str:
        keys = self._count_keys
        k = keys.get((prefix, backend))
        if k is None:
            k = keys[(prefix, backend)] = prefix + str(backend)
        return k

    # -- pools ----------------------------------------------------------------
    def pool_created(self, pool, t) -> None:
        self.events.append(
            (
                "pool_created",
                t,
                f"pool {pool.pool_id}",
                {
                    "pool_id": pool.pool_id,
                    "n_nodes": len(pool.allocation.storage_nodes),
                    "capacity_bytes": pool.capacity_bytes,
                },
            )
        )

    def pool_retired(self, pool, t) -> None:
        self.events.append(
            ("pool_retired", t, f"pool {pool.pool_id}", {"pool_id": pool.pool_id})
        )

    def pool_torn_down(self, pool, t) -> None:
        self.events.append(
            ("pool_torn_down", t, f"pool {pool.pool_id}", {"pool_id": pool.pool_id})
        )

    def lease_attached(self, lease, pool, n_hits, n_misses, t) -> None:
        self.events.append(
            (
                "lease_attached",
                t,
                lease.job_name,
                {
                    "pool_id": pool.pool_id,
                    "hits": n_hits,
                    "misses": n_misses,
                },
            )
        )

    def lease_released(self, lease, t) -> None:
        self.events.append(
            (
                "lease_released",
                t,
                lease.job_name,
                {"pool_id": lease.pool_id},
            )
        )

    def eviction(self, pool_id, dataset_name, nbytes) -> None:
        t = self._clock()
        self.count("pool.evictions")
        self.events.append(
            (
                "eviction",
                t,
                dataset_name,
                {"pool_id": pool_id, "nbytes": nbytes},
            )
        )

    # -- chaos (node failure domain) -------------------------------------------
    def node_down(self, node_id, t) -> None:
        self.count("chaos.node_downs")
        self.events.append(("node_down", t, node_id, {"node_id": node_id}))

    def node_repair(self, node_id, t) -> None:
        self.count("chaos.node_repairs")
        self.events.append(("node_repair", t, node_id, {"node_id": node_id}))

    def degraded(self, job, node_id, t) -> None:
        self.count("chaos.degraded")
        self.events.append(
            (
                "degraded",
                t,
                job.spec.name,
                {"job_id": job.job_id, "node_id": node_id, "attempt": job.attempt},
            )
        )

    def rebuild(self, pool, node_id, *, via, t) -> None:
        self.count("chaos.rebuilds")
        self.events.append(
            (
                "rebuild",
                t,
                f"pool {pool.pool_id}",
                {"pool_id": pool.pool_id, "node_id": node_id, "via": via},
            )
        )

    # -- pilots (two-level scheduling) -----------------------------------------
    def pilot_started(self, name, job_id, t, *, n_tasks, n_slots, packed) -> None:
        self.count("pilot.started")
        self.events.append(
            (
                "pilot_started",
                t,
                name,
                {
                    "job_id": job_id, "n_tasks": n_tasks,
                    "n_slots": n_slots, "packed": packed,
                },
            )
        )

    def task_batch(
        self, name, job_id, t, *,
        completed, failed, requeued, packed, queued, running, occupancy,
    ) -> None:
        """One coalesced completion batch inside a pilot — the O(1) event
        the engine sees in place of per-task lifecycles. Also feeds the
        per-pilot occupancy series (``pilot_occupancy/<name>``)."""
        self.count("pilot.batches")
        if completed:
            self.count("pilot.tasks_done", completed)
        if failed:
            self.count("pilot.tasks_failed", failed)
        if requeued:
            self.count("pilot.task_retries", requeued)
        self.events.append(
            (
                "task_batch",
                t,
                name,
                {
                    "job_id": job_id, "completed": completed, "failed": failed,
                    "requeued": requeued, "packed": packed, "queued": queued,
                    "running": running, "occupancy": occupancy,
                },
            )
        )
        hub = self.metrics
        if hub is not None:
            hub.record("pilot_occupancy/" + name, t, occupancy)

    def pilot_resized(self, name, job_id, t, *, n_slots, cause, packed) -> None:
        self.count("pilot.resized")
        self.events.append(
            (
                "pilot_resized",
                t,
                name,
                {
                    "job_id": job_id, "n_slots": n_slots,
                    "cause": cause, "packed": packed,
                },
            )
        )

    # -- scheduler ------------------------------------------------------------
    def sched_grant(self, allocation) -> None:
        self.count("scheduler.grants")

    def sched_release(self, allocation) -> None:
        self.count("scheduler.releases")

    # -- engine ---------------------------------------------------------------
    def engine_sample(self, t, heap_len, events_processed) -> None:
        hub = self.metrics
        if hub is not None:
            hub.record("engine_heap_depth", t, heap_len)
        self._tick(t)

    # -- introspection --------------------------------------------------------
    @property
    def n_spans(self) -> int:
        return sum(len(v) for v in self.spans.values())

    def t_range(self) -> tuple[float, float]:
        """(earliest submit-or-span start, latest span end) over the trace;
        ``(0.0, 0.0)`` when nothing was recorded."""
        if not self.spans and not self.job_meta:
            # span-free traces (e.g. serving campaigns record only typed
            # events) still have a meaningful window: the event timestamps
            if self.events:
                ts = [e[1] for e in self.events]
                return (min(ts), max(ts))
            return (0.0, 0.0)
        starts = [m["submit"] for m in self.job_meta.values()]
        t_end = 0.0
        for spans in self.spans.values():
            if spans:
                starts.append(spans[0][1])
                t_end = max(t_end, spans[-1][2])
        t0 = min(starts) if starts else 0.0
        return (t0, max(t_end, t0))
