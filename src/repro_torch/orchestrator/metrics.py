"""Campaign telemetry: per-job latency breakdowns and cluster-level rollups.

Everything here is derived from the `JobRecord.history` transition logs the
lifecycle machine writes — no live instrumentation, so a report can be
computed for any subset of jobs at any point of the campaign.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .lifecycle import TERMINAL_STATES, JobRecord, JobState, LiveCounters

# Phases reported in per-job latency breakdowns, pipeline order.
BREAKDOWN_STATES = (
    JobState.QUEUED,
    JobState.PROVISIONING,
    JobState.STAGING_IN,
    JobState.RUNNING,
    JobState.STAGING_OUT,
    JobState.TEARDOWN,
)


@dataclasses.dataclass(frozen=True)
class JobBreakdown:
    """Seconds spent per lifecycle phase, summed across retries."""

    name: str
    job_id: int
    final_state: JobState
    attempts: int
    phase_s: dict
    total_s: float

    @property
    def queue_wait_s(self) -> float:
        return self.phase_s.get(JobState.QUEUED, 0.0)


@dataclasses.dataclass(frozen=True)
class PoolReport:
    """Persistent-pool telemetry attached to a campaign report."""

    n_pools: int                 # ever created
    n_live: int                  # not yet retired at summarize time
    dataset_hits: int
    dataset_misses: int
    hit_rate: float              # hits / (hits + misses), dataset-granular
    stage_in_bytes_saved: float  # traffic avoided by cache hits
    bytes_staged: float          # dataset bytes pulled into pools
    evictions: int
    evicted_bytes: float
    occupancy: float             # mean used/capacity over live pools
    leases_granted: int
    pools_retired: int


@dataclasses.dataclass(frozen=True)
class CampaignReport:
    n_jobs: int
    n_done: int
    n_failed: int
    makespan_s: float
    storage_node_utilization: float      # busy node-seconds / capacity
    total_retries: int
    staged_in_bytes: float
    staged_out_bytes: float
    mean_queue_wait_s: float
    max_queue_wait_s: float
    mean_phase_s: dict
    breakdowns: tuple
    stage_in_bytes_saved: float = 0.0    # summed over jobs (pool cache hits)
    pool: Optional[PoolReport] = None
    # fault-tolerance rollups (checkpoint-aware requeue + preemption)
    checkpoints_committed: int = 0
    preemptions: int = 0                 # checkpoint-and-release requeues
    resumes: int = 0                     # attempts started with committed work
    run_s_saved: float = 0.0             # run seconds resumes did not replay
    # pilot (two-level scheduling) rollups — folded from each pilot job's
    # in-pilot TaskScheduler stats
    n_pilots: int = 0
    tasks_submitted: int = 0
    tasks_done: int = 0
    tasks_failed: int = 0
    task_retries: int = 0
    #: makespan attribution from the span DAG (a
    #: :class:`repro.obs.profile.CriticalPath`); populated when
    #: :func:`summarize` is handed the campaign's trace recorder
    critical_path: Optional[object] = None
    #: SLO / error-budget accounting (a :class:`repro.obs.slo.SLOReport`);
    #: populated when the trace handed to :func:`summarize` carries an
    #: :class:`~repro.obs.alerts.AlertEngine` with an SLO tracker attached
    slo: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class LiveReport:
    """O(1) mid-flight snapshot built from the orchestrator's incremental
    `LiveCounters` — no per-job scan, no history folds. The batch
    :func:`summarize` remains the reference; the regression tests hold the
    shared fields equal at arbitrary poll instants."""

    t: float
    n_jobs: int
    n_done: int
    n_failed: int
    retries: int
    preemptions: int
    resumes: int
    checkpoints_committed: int
    run_s_saved: float
    staged_in_bytes: float
    staged_out_bytes: float
    stage_in_bytes_saved: float
    makespan_s: float
    storage_node_utilization: float
    # pilot (two-level scheduling) rollups
    n_pilots: int = 0
    tasks_submitted: int = 0
    tasks_done: int = 0
    tasks_failed: int = 0
    task_retries: int = 0


def live_report(
    counters: LiveCounters, *, n_storage_nodes: int, now: float
) -> LiveReport:
    """Fold `LiveCounters` into a `LiveReport` at instant ``now``."""
    return LiveReport(
        t=now,
        n_jobs=counters.n_jobs,
        n_done=counters.n_done,
        n_failed=counters.n_failed,
        retries=counters.retries,
        preemptions=counters.preemptions,
        resumes=counters.resumes,
        checkpoints_committed=counters.checkpoints,
        run_s_saved=counters.run_s_saved,
        staged_in_bytes=counters.staged_in_bytes,
        staged_out_bytes=counters.staged_out_bytes,
        stage_in_bytes_saved=counters.stage_in_saved_bytes,
        makespan_s=counters.makespan_s(now),
        storage_node_utilization=counters.utilization(n_storage_nodes, now),
        n_pilots=counters.pilots,
        tasks_submitted=counters.tasks_submitted,
        tasks_done=counters.tasks_done,
        tasks_failed=counters.tasks_failed,
        task_retries=counters.task_retries,
    )


def job_breakdown(job: JobRecord, now: Optional[float] = None) -> JobBreakdown:
    """Fold a job's transition history into per-phase durations."""
    phase_s: dict = {s: 0.0 for s in BREAKDOWN_STATES}
    hist = job.history
    for (state, t0), (_, t1) in zip(hist, hist[1:]):
        if state in phase_s:
            phase_s[state] += t1 - t0
    if hist and hist[-1][0] not in TERMINAL_STATES and now is not None:
        state, t0 = hist[-1]
        if state in phase_s:
            phase_s[state] += now - t0
    end = hist[-1][1] if hist else job.submit_time
    if now is not None and job.state not in TERMINAL_STATES:
        end = now
    # each attempt (initial or requeue) opens with a QUEUED transition, so
    # the count is exact for DONE, FAILED-exhausted, and still-running jobs
    attempts = max(1, sum(s is JobState.QUEUED for s, _ in hist))
    return JobBreakdown(
        name=job.spec.name,
        job_id=job.job_id,
        final_state=job.state,
        attempts=attempts,
        phase_s=phase_s,
        total_s=end - job.submit_time,
    )


def storage_node_utilization(
    jobs: Sequence[JobRecord],
    n_storage_nodes: int,
    makespan_s: float,
    now: Optional[float] = None,
) -> float:
    """Busy storage-node-seconds over the campaign's node-second capacity.

    Pass ``now`` for a mid-campaign snapshot: allocations still open at
    ``now`` count as busy from their start time."""
    if n_storage_nodes <= 0 or makespan_s <= 0:
        return 0.0
    busy = sum(
        (t1 - t0) * n for job in jobs for (t0, t1, n) in job.storage_intervals
    )
    if now is not None:
        busy += sum(
            (now - job.alloc_started) * len(job.allocation.storage_nodes)
            for job in jobs
            if job.allocation is not None and job.alloc_started is not None
        )
    return busy / (n_storage_nodes * makespan_s)


def pool_report(pools) -> PoolReport:
    """Snapshot a :class:`~repro.pool.PoolManager` for a campaign report."""
    stats = pools.stats
    return PoolReport(
        n_pools=stats.pools_created,
        n_live=len(pools.live_pools),
        dataset_hits=stats.dataset_hits,
        dataset_misses=stats.dataset_misses,
        hit_rate=stats.hit_rate,
        stage_in_bytes_saved=stats.bytes_saved,
        bytes_staged=stats.bytes_staged,
        evictions=pools.evictor.evictions,
        evicted_bytes=pools.evictor.evicted_bytes,
        occupancy=pools.occupancy(),
        leases_granted=stats.leases_granted,
        pools_retired=stats.pools_retired,
    )


def summarize(
    jobs: Sequence[JobRecord],
    *,
    n_storage_nodes: int,
    now: Optional[float] = None,
    pools=None,
    trace=None,
) -> CampaignReport:
    """Fold job records into a :class:`CampaignReport`. Pass the campaign's
    :class:`~repro.obs.trace.TraceRecorder` as ``trace`` to also attach the
    critical-path makespan attribution (see :mod:`repro.obs.profile`)."""
    if not jobs:
        raise ValueError("no jobs to summarize")
    breakdowns = tuple(job_breakdown(j, now) for j in jobs)
    t_start = min(j.submit_time for j in jobs)
    t_end = max(
        (h[-1][1] for j in jobs if (h := j.history)), default=t_start
    )
    if now is not None:
        t_end = max(t_end, now)
    makespan = t_end - t_start
    utilization = storage_node_utilization(jobs, n_storage_nodes, makespan, now)
    if pools is not None and makespan > 0 and n_storage_nodes > 0:
        # pool-held nodes are busy from creation to retirement (or still),
        # clipped to the campaign window — jobs' own intervals don't see them
        busy = 0.0
        for p in pools.pools:
            end = p.retired_at if p.retired_at is not None else t_end
            span = min(end, t_end) - max(p.created_at, t_start)
            busy += len(p.allocation.storage_nodes) * max(0.0, span)
        utilization += busy / (n_storage_nodes * makespan)
    n_pilots = tasks_submitted = tasks_done = tasks_failed = task_retries = 0
    for j in jobs:
        if j.pilot is None:
            continue
        n_pilots += 1
        st = j.pilot.stats
        tasks_submitted += st.submitted
        tasks_done += st.done
        tasks_failed += st.failed
        task_retries += st.retries
    waits = [b.queue_wait_s for b in breakdowns]
    mean_phase = {
        s: sum(b.phase_s[s] for b in breakdowns) / len(breakdowns)
        for s in BREAKDOWN_STATES
    }
    return CampaignReport(
        n_jobs=len(jobs),
        n_done=sum(j.state is JobState.DONE for j in jobs),
        n_failed=sum(j.state is JobState.FAILED for j in jobs),
        makespan_s=makespan,
        storage_node_utilization=utilization,
        total_retries=sum(b.attempts - 1 for b in breakdowns),
        staged_in_bytes=sum(j.staged_in_bytes for j in jobs),
        staged_out_bytes=sum(j.staged_out_bytes for j in jobs),
        mean_queue_wait_s=sum(waits) / len(waits),
        max_queue_wait_s=max(waits),
        mean_phase_s=mean_phase,
        breakdowns=breakdowns,
        stage_in_bytes_saved=sum(j.stage_in_saved_bytes for j in jobs),
        pool=pool_report(pools) if pools is not None else None,
        checkpoints_committed=sum(j.checkpoints_committed for j in jobs),
        preemptions=sum(j.preemptions for j in jobs),
        resumes=sum(j.resume_attempts for j in jobs),
        run_s_saved=sum(j.run_s_saved for j in jobs),
        n_pilots=n_pilots,
        tasks_submitted=tasks_submitted,
        tasks_done=tasks_done,
        tasks_failed=tasks_failed,
        task_retries=task_retries,
        critical_path=_critical_path(trace),
        slo=_slo_report(trace),
    )


def _critical_path(trace):
    """Offline reporting step — imported lazily so the hot lifecycle path
    never loads the profiler (tools/check_obs_imports.py allows hot modules
    only module-level imports of the recorder interface)."""
    if trace is None:
        return None
    from ..obs.profile import critical_path

    return critical_path(trace)


def _slo_report(trace):
    """Fold the trace's SLO accounting into the report, when an alert
    engine with a tracker rides the recorder (duck-typed off the recorder's
    ``alerts`` attribute — no obs import needed at all)."""
    alerts = getattr(trace, "alerts", None)
    if alerts is None or alerts.slos is None:
        return None
    return alerts.slos.report()


def format_report(report: CampaignReport, *, top_n: int = 10) -> str:
    """Human-readable campaign summary + the ``top_n`` slowest jobs."""
    lines = [
        f"jobs: {report.n_jobs} ({report.n_done} done, {report.n_failed} failed, "
        f"{report.total_retries} retries)",
        f"makespan: {report.makespan_s:,.1f} s (virtual)",
        f"storage-node utilization: {report.storage_node_utilization:.1%}",
        f"staged: {report.staged_in_bytes / 1e9:,.1f} GB in, "
        f"{report.staged_out_bytes / 1e9:,.1f} GB out",
        f"queue wait: mean {report.mean_queue_wait_s:,.1f} s, "
        f"max {report.max_queue_wait_s:,.1f} s",
        "mean phase breakdown (s): "
        + "  ".join(
            f"{s.value}={report.mean_phase_s[s]:,.1f}" for s in BREAKDOWN_STATES
        ),
    ]
    if report.checkpoints_committed or report.preemptions or report.resumes:
        lines.append(
            f"fault tolerance: {report.checkpoints_committed} checkpoints, "
            f"{report.resumes} resumes ({report.run_s_saved:,.1f} s of run "
            f"time not replayed), {report.preemptions} preemptions"
        )
    if report.n_pilots:
        lines.append(
            f"pilots: {report.n_pilots} ({report.tasks_done:,} of "
            f"{report.tasks_submitted:,} tasks done, {report.tasks_failed} "
            f"failed, {report.task_retries} in-pilot task retries)"
        )
    if report.pool is not None:
        p = report.pool
        lines += [
            f"pools: {p.n_pools} created ({p.n_live} live, {p.pools_retired} "
            f"retired), {p.leases_granted} leases",
            f"dataset cache: {p.dataset_hits} hits / {p.dataset_misses} misses "
            f"(hit rate {p.hit_rate:.1%}), "
            f"{p.stage_in_bytes_saved / 1e9:,.1f} GB stage-in saved, "
            f"{p.bytes_staged / 1e9:,.1f} GB staged into pools",
            f"evictions: {p.evictions} ({p.evicted_bytes / 1e9:,.1f} GB), "
            f"pool occupancy {p.occupancy:.1%}",
        ]
    if report.critical_path is not None:
        from ..obs.profile import format_critical_path

        lines.append(format_critical_path(report.critical_path))
    if report.slo is not None:
        from ..obs.slo import format_slo_report

        lines.append(format_slo_report(report.slo))
    lines.append(f"slowest {min(top_n, report.n_jobs)} jobs:")
    slowest = sorted(report.breakdowns, key=lambda b: -b.total_s)[:top_n]
    for b in slowest:
        phases = "  ".join(
            f"{s.value}={b.phase_s[s]:,.1f}" for s in BREAKDOWN_STATES
        )
        lines.append(
            f"  {b.name:<20s} {b.final_state.value:<7s} x{b.attempts} "
            f"total={b.total_s:,.1f}s  {phases}"
        )
    return "\n".join(lines)
