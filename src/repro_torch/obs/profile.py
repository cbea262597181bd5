"""Critical-path profiler: attribute campaign makespan to phases.

Given a finished campaign's trace, walk the span DAG *backwards* from the
last thing that happened to the first submission, and charge every second
of wall time on that path to exactly one bucket — the generalized form of
the paper's "deploy vs stage vs compute" breakdown.

The walk: start at the job whose span ends last, at that instant. Move
backwards through the current job's phase spans, charging each to its
phase. When the cursor enters a QUEUED span, consult the recorder's
grant-causality edges: if the grant that ended this wait was *enabled by*
another job's release at the same instant, the path jumps to that job —
its activity, not abstract "queue wait", is what the makespan was spent
on. Waits with no recorded enabler (campaign-start contention, arrivals)
stay charged to ``queue_wait``. Time before the path-origin job's first
span is its ``arrival`` lead-in; any gap the trace cannot explain is
``unattributed`` rather than silently absorbed.

Buckets are disjoint and tile ``[t_start, t_end]`` exactly, so
``sum(phase_s.values()) == makespan_s`` by construction — the invariant
``examples/trace_campaign.py`` and the tests assert.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Phase keys a critical path may contain, in display order.
PHASES = (
    "arrival",
    "queue_wait",
    "allocated",
    "provisioning",
    "staging_in",
    "running",
    "staging_out",
    "teardown",
    "unattributed",
)

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One stretch of the critical path charged to one job's phase."""

    job_id: Optional[int]
    name: Optional[str]
    phase: str
    t0: float
    t1: float

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class CriticalPath:
    """Makespan attribution: ``phase_s`` tiles ``[t_start, t_end]``."""

    t_start: float
    t_end: float
    phase_s: dict[str, float]
    segments: tuple[PathSegment, ...]

    @property
    def makespan_s(self) -> float:
        return self.t_end - self.t_start

    def fraction(self, phase: str) -> float:
        span = self.makespan_s
        return self.phase_s.get(phase, 0.0) / span if span > 0 else 0.0


def _grant_cause(trace, job_id: int, t: float) -> Optional[int]:
    """The job whose release enabled ``job_id``'s grant at instant ``t``."""
    for gt, cause in reversed(trace.grant_causes.get(job_id, ())):
        if abs(gt - t) <= _EPS:
            return cause
        if gt < t - _EPS:
            break
    return None


def critical_path(trace) -> Optional[CriticalPath]:
    """Walk the span DAG of a finished campaign; ``None`` if the trace is
    empty. ``trace`` is a :class:`~repro.obs.trace.TraceRecorder` (or
    anything exposing ``spans`` / ``job_meta`` / ``grant_causes`` /
    ``t_range()``)."""
    spans = {j: s for j, s in trace.spans.items() if s}
    if not spans:
        return None
    t_start, t_end = trace.t_range()
    if t_end - t_start <= 0:
        return CriticalPath(t_start, t_end, {}, ())

    # path origin: the job whose last span ends last (ties: lowest id,
    # deterministic across runs)
    cur = min(spans, key=lambda j: (-spans[j][-1][2], j))
    cursor = t_end
    segments: list[PathSegment] = []
    jumped: set[tuple[int, float]] = set()

    def charge(job_id: Optional[int], phase: str, a: float, b: float) -> None:
        if b - a <= _EPS:
            return
        name = trace.job_meta.get(job_id, {}).get("name") if job_id is not None else None
        segments.append(PathSegment(job_id, name, phase, a, b))

    max_steps = 4 * sum(len(s) for s in spans.values()) + 16
    steps = 0
    while cursor > t_start + _EPS:
        steps += 1
        if steps > max_steps:                      # pathological trace: bail
            charge(None, "unattributed", t_start, cursor)
            cursor = t_start
            break
        job_spans = spans[cur]
        # rightmost span of the current job starting strictly before cursor
        idx = None
        for i in range(len(job_spans) - 1, -1, -1):
            if job_spans[i][1] < cursor - _EPS:
                idx = i
                break
        if idx is None:
            # before this job's first activity: arrival lead-in
            charge(cur, "arrival", t_start, cursor)
            cursor = t_start
            break
        phase, a, b = job_spans[idx]
        hi = min(b, cursor)
        if hi < cursor - _EPS:
            # nothing of this job (or its causes) covers (hi, cursor)
            charge(None, "unattributed", hi, cursor)
            cursor = hi
        if phase == "queued":
            cause = _grant_cause(trace, cur, hi)
            key = (cur, hi)
            if (
                cause is not None
                and cause in spans
                and key not in jumped
            ):
                # the wait ended because `cause` released: follow it
                jumped.add(key)
                cur = cause
                cursor = hi
                continue
            charge(cur, "queue_wait", a, hi)
        else:
            charge(cur, phase if phase in PHASES else "unattributed", a, hi)
        cursor = a

    segments.reverse()
    phase_s = {}
    for seg in segments:
        phase_s[seg.phase] = phase_s.get(seg.phase, 0.0) + seg.dur_s
    # float drift from summing many segments: pin the tiling invariant by
    # folding the residue into the largest bucket
    residue = (t_end - t_start) - sum(phase_s.values())
    if phase_s and abs(residue) > 0:
        top = max(phase_s, key=lambda k: phase_s[k])
        phase_s[top] += residue
    return CriticalPath(t_start, t_end, phase_s, tuple(segments))


def format_critical_path(cp: CriticalPath, *, max_segments: int = 0) -> str:
    """Human-readable breakdown; ``max_segments`` > 0 also lists the
    longest individual path segments."""
    lines = [
        f"critical path: {cp.makespan_s:.1f}s "
        f"({cp.t_start:.1f}s -> {cp.t_end:.1f}s), "
        f"{len(cp.segments)} segments"
    ]
    for phase in PHASES:
        s = cp.phase_s.get(phase, 0.0)
        if s <= 0:
            continue
        lines.append(f"  {phase:<14} {s:>12.1f}s  {100 * cp.fraction(phase):5.1f}%")
    if max_segments > 0:
        longest = sorted(cp.segments, key=lambda s: -s.dur_s)[:max_segments]
        lines.append("  longest segments:")
        for seg in longest:
            who = seg.name if seg.name is not None else "-"
            lines.append(
                f"    {seg.phase:<14} {seg.dur_s:>10.1f}s  "
                f"[{seg.t0:.1f}, {seg.t1:.1f}]  {who}"
            )
    return "\n".join(lines)
