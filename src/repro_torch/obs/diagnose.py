"""Campaign doctor: cross-reference the trace into ranked advisories.

:func:`diagnose` reads a finished (or mid-flight) campaign's evidence —
the critical-path phase buckets, the metrics series, negotiation
rejections, eviction/preemption counters, reservation events — and emits
:class:`Advisory` records ranked by severity: what the campaign was
actually bound by, with the numbers that prove it and the knob to turn.

The checks (each fires only when its evidence clears a threshold):

* **stage_in_bound** — staging-in dominates the critical path; pairs the
  fraction with the pool hit rate ("stage-in bound: 61% of makespan, pool
  hit-rate 12% — grow the pool / route with DataAwarePolicy").
* **provisioning_bound** — per-job deploy/teardown dominates; pooled
  lease-attach skips it.
* **head_blocking** — queue wait dominates and one wide job's active span
  overlaps most of everyone else's queued time (found with an
  interval-sweep integral, not an O(jobs²) scan): the scheduler is
  head-blocked behind it; backfill / EASY reservations are the knob.
* **pool_thrash** — the same datasets get evicted and re-staged over and
  over: the pool is too small for the working set.
* **fault_churn** — requeued faults are eating the campaign; checkpoints
  bound the replay cost.
* **node_churn** — storage nodes died mid-campaign: how many attempts ran
  degraded or refaulted, and whether pools healed by backfill or repair.
* **negotiation_pressure** — specs failing negotiation outright, with the
  per-backend rejection reasons histogrammed.
* **slo_breach** — any SLO with its error budget overspent (when an
  :class:`~repro.obs.slo.SLOReport` is handed in).
* **serving_queue_bound** — serving campaigns (span-free traces with
  replica lifecycle events): the TTFT tail is queueing for a slot rather
  than prefill; capacity should arrive earlier.

Pure reporting: reads the recorder/hub, never the live engine. Cold-side
module — hot loops never import it (``tools/check_obs_imports``).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

from .profile import critical_path

__all__ = ["Advisory", "diagnose", "format_advisories"]

#: Lifecycle phases that count as "the job holds resources / is active".
_ACTIVE_PHASES = (
    "allocated",
    "provisioning",
    "staging_in",
    "running",
    "staging_out",
    "teardown",
)


@dataclasses.dataclass(frozen=True)
class Advisory:
    """One ranked, evidence-backed finding."""

    code: str
    severity: float            # ranking weight, roughly "fraction of campaign"
    summary: str
    recommendation: str
    evidence: dict

    def __str__(self) -> str:
        return f"[{self.code} {self.severity:.2f}] {self.summary}"


# -- helpers ------------------------------------------------------------------

def _hit_rate(trace, metrics, report) -> Optional[float]:
    """Dataset cache hit rate, from the report if present, else the probe."""
    pool = getattr(report, "pool", None) if report is not None else None
    if pool is not None:
        return pool.hit_rate
    if metrics is not None:
        s = metrics.series.get("catalog_hit_rate")
        if s is not None and len(s):
            return s.last()[1]
    return None


class _QueuedIntegral:
    """Step-function integral of queued-job concurrency over time.

    Built once from every queued span; ``between(a, b)`` returns total
    queued job-seconds inside ``[a, b]`` in O(log n).
    """

    def __init__(self, queued_spans):
        deltas: dict[float, int] = {}
        for t0, t1 in queued_spans:
            if t1 > t0:
                deltas[t0] = deltas.get(t0, 0) + 1
                deltas[t1] = deltas.get(t1, 0) - 1
        self.ts = sorted(deltas)
        self.counts = []           # concurrency on [ts[i], ts[i+1])
        self.cum = []              # integral from ts[0] to ts[i]
        level = 0
        acc = 0.0
        prev = None
        for t in self.ts:
            if prev is not None:
                acc += level * (t - prev)
            self.cum.append(acc)
            level += deltas[t]
            self.counts.append(level)
            prev = t

    def _at(self, t: float) -> float:
        """Integral from ts[0] to ``t`` (level past the last edge is 0)."""
        if not self.ts or t <= self.ts[0]:
            return 0.0
        i = bisect.bisect_right(self.ts, t) - 1
        return self.cum[i] + self.counts[i] * (t - self.ts[i])

    def between(self, a: float, b: float) -> float:
        if b <= a:
            return 0.0
        return self._at(b) - self._at(a)


# -- checks -------------------------------------------------------------------

def _check_stage_in_bound(cp, trace, metrics, report, churned) -> Optional[Advisory]:
    frac = cp.fraction("staging_in")
    if frac < 0.35:
        return None
    hit = _hit_rate(trace, metrics, report)
    hit_txt = f", pool hit-rate {hit:.0%}" if hit is not None else ""
    churn_txt = " (partly self-inflicted: see pool_thrash)" if churned else ""
    rec = (
        "grow the pool / working-set capacity so hot datasets stay resident"
        if hit is not None
        else "enable persistent pools so shared datasets stage once "
        "(Orchestrator.enable_pools + DataAwarePolicy)"
    )
    return Advisory(
        code="stage_in_bound",
        # churn makes the re-staging a symptom, not the root cause — rank
        # the thrash advisory above this one in that case
        severity=frac * (0.6 if churned else 1.0),
        summary=(
            f"stage-in bound: {frac:.0%} of the makespan's critical path is "
            f"staging data in{hit_txt}{churn_txt}"
        ),
        recommendation=rec,
        evidence={
            "staging_in_fraction": round(frac, 4),
            "staging_in_s": round(cp.phase_s.get("staging_in", 0.0), 1),
            "hit_rate": None if hit is None else round(hit, 4),
        },
    )


def _check_provisioning_bound(cp) -> Optional[Advisory]:
    frac = cp.fraction("provisioning") + cp.fraction("teardown")
    if frac < 0.25:
        return None
    return Advisory(
        code="provisioning_bound",
        severity=frac,
        summary=(
            f"provisioning bound: {frac:.0%} of the critical path is per-job "
            "filesystem deploy/teardown"
        ),
        recommendation=(
            "route jobs through POOLED storage specs: a lease attach skips "
            "the per-job deploy/teardown entirely"
        ),
        evidence={
            "provisioning_s": round(cp.phase_s.get("provisioning", 0.0), 1),
            "teardown_s": round(cp.phase_s.get("teardown", 0.0), 1),
            "fraction": round(frac, 4),
        },
    )


def _check_head_blocking(cp, trace) -> Optional[Advisory]:
    frac = cp.fraction("queue_wait")
    if frac < 0.30:
        return None
    spans = trace.spans
    queued = [
        (t0, t1)
        for s in spans.values()
        for phase, t0, t1 in s
        if phase == "queued" and t1 > t0
    ]
    if not queued:
        return None
    integral = _QueuedIntegral(queued)
    # width per job from its grants (compute + storage nodes actually held)
    width: dict[int, int] = {}
    for kind, _t, _label, args in trace.events:
        if kind == "grant":
            w = args.get("n_compute", 0) + args.get("n_storage", 0)
            jid = args["job_id"]
            if w > width.get(jid, 0):
                width[jid] = w
    best_jid, best_score, best_overlap = None, 0.0, 0.0
    for jid, s in spans.items():
        overlap = sum(
            integral.between(t0, t1)
            for phase, t0, t1 in s
            if phase in _ACTIVE_PHASES
        )
        score = overlap * max(1, width.get(jid, 1))
        if score > best_score or (score == best_score and best_jid is not None
                                  and jid < best_jid):
            best_jid, best_score, best_overlap = jid, score, overlap
    if best_jid is None or best_overlap <= 0:
        return None
    meta = trace.job_meta.get(best_jid, {})
    name = meta.get("name", f"job {best_jid}")
    n_res = sum(1 for e in trace.events if e[0] == "reservation")
    return Advisory(
        code="head_blocking",
        severity=frac,
        summary=(
            f"scheduler head-blocked: {frac:.0%} of the critical path is "
            f"queue wait, mostly behind {name!r} (#{best_jid}, width "
            f"{width.get(best_jid, 1)} nodes, {best_overlap:,.0f} queued "
            "job-seconds overlapped its run)"
        ),
        recommendation=(
            "let narrow jobs around the head: BackfillPolicy, or "
            "EasyBackfillPolicy for a no-starvation reservation proof"
        ),
        evidence={
            "queue_wait_fraction": round(frac, 4),
            "blocker_job_id": best_jid,
            "blocker_name": name,
            "blocker_width": width.get(best_jid, 1),
            "queued_job_s_overlapped": round(best_overlap, 1),
            "reservations_recorded": n_res,
        },
    )


def _check_pool_thrash(trace, n_jobs) -> Optional[Advisory]:
    evictions: dict[str, int] = {}
    evicted_bytes = 0.0
    for kind, _t, label, args in trace.events:
        if kind == "eviction":
            evictions[label] = evictions.get(label, 0) + 1
            evicted_bytes += args.get("nbytes", 0.0)
    if not evictions:
        return None
    top = max(evictions.items(), key=lambda kv: (kv[1], kv[0]))
    if top[1] < 3:
        return None
    restages = top[1] + 1                   # evicted N times => staged N+1
    return Advisory(
        code="pool_thrash",
        severity=min(1.0, 0.5 + 0.06 * top[1]),
        summary=(
            f"eviction churn: dataset {top[0]!r} re-staged {restages}x "
            f"({sum(evictions.values())} evictions total, "
            f"{evicted_bytes / 1e9:,.1f} GB evicted) — the pool is smaller "
            "than the working set"
        ),
        recommendation=(
            "grow the pool's capacity (or add a pool) so the hot datasets "
            "fit resident; churned stage-in traffic is pure waste"
        ),
        evidence={
            "top_dataset": top[0],
            "top_evictions": top[1],
            "total_evictions": sum(evictions.values()),
            "evicted_bytes": evicted_bytes,
            "datasets_churned": {
                k: v for k, v in sorted(
                    evictions.items(), key=lambda kv: (-kv[1], kv[0])
                )[:5]
            },
        },
    )


def _check_fault_churn(trace, n_jobs) -> Optional[Advisory]:
    requeued = sum(
        1 for k, _t, _l, a in trace.events if k == "fault" and a.get("requeued")
    )
    if requeued < max(3, 0.15 * n_jobs):
        return None
    checkpoints = sum(1 for e in trace.events if e[0] == "checkpoint")
    sev = min(1.0, requeued / max(1, n_jobs))
    ckpt_txt = (
        "no checkpoints were committed — every retry replays from scratch"
        if checkpoints == 0
        else f"{checkpoints} checkpoint commits bound the replay"
    )
    return Advisory(
        code="fault_churn",
        severity=sev,
        summary=(
            f"fault churn: {requeued} attempts requeued by faults across "
            f"{n_jobs} jobs; {ckpt_txt}"
        ),
        recommendation=(
            "set checkpoint_every_s/checkpoint_bytes on fault-prone specs "
            "so resumes pay only the uncommitted remainder"
        ),
        evidence={"requeued_faults": requeued, "checkpoints": checkpoints},
    )


def _check_node_churn(trace, n_jobs) -> Optional[Advisory]:
    """Storage nodes dying mid-campaign: count the losses and what they
    cost — attempts degraded or faulted, pool rebuilds paid. Fires on any
    node loss at all; severity scales with the per-job damage."""
    downs = sum(1 for e in trace.events if e[0] == "node_down")
    if downs == 0:
        return None
    repairs = sum(1 for e in trace.events if e[0] == "node_repair")
    degraded = sum(1 for e in trace.events if e[0] == "degraded")
    rebuilds = {"repair": 0, "backfill": 0}
    for kind, _t, _l, args in trace.events:
        if kind == "rebuild":
            via = args.get("via", "repair")
            rebuilds[via] = rebuilds.get(via, 0) + 1
    faults = sum(
        1 for k, _t, _l, a in trace.events if k == "fault" and a.get("requeued")
    )
    sev = min(1.0, 0.3 + 0.5 * (degraded + faults) / max(1, n_jobs))
    return Advisory(
        code="node_churn",
        severity=sev,
        summary=(
            f"node churn: {downs} storage-node failure(s) "
            f"({repairs} repaired, {rebuilds['backfill']} pool backfill(s), "
            f"{rebuilds['repair']} re-silver(s)); {degraded} attempt(s) ran "
            f"DEGRADED and {faults} requeued on faults"
        ),
        recommendation=(
            "mirror critical specs (placement.mirror with a redundancy-"
            "capable backend) and arm pool self-healing with a RetryPolicy "
            "so capacity backfills instead of waiting out the MTTR"
        ),
        evidence={
            "node_downs": downs,
            "node_repairs": repairs,
            "degraded_attempts": degraded,
            "rebuilds": rebuilds,
            "requeued_faults": faults,
        },
    )


def _check_negotiation_pressure(trace) -> Optional[Advisory]:
    failed = 0
    reasons: dict[str, int] = {}
    for kind, _t, _l, args in trace.events:
        if kind != "negotiation" or args.get("ok"):
            continue
        failed += 1
        for r in args.get("rejections", ()):
            key = f"{r['backend']}: {r['reason']}"
            reasons[key] = reasons.get(key, 0) + 1
    if failed == 0:
        return None
    top = sorted(reasons.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    return Advisory(
        code="negotiation_pressure",
        severity=min(1.0, 0.3 + 0.05 * failed),
        summary=(
            f"negotiation pressure: {failed} spec(s) found no backend; "
            "top rejection: " + (top[0][0] if top else "n/a")
        ),
        recommendation=(
            "widen the spec's manager fallbacks or register a backend with "
            "the missing capability"
        ),
        evidence={"failed_negotiations": failed, "rejections": dict(top)},
    )


def _check_serving_queue_bound(trace, metrics) -> Optional[Advisory]:
    """Serving campaigns have no job spans — their evidence is the replica
    lifecycle events plus the TTFT histogram. Fires when the TTFT tail is
    dominated by queueing: prefill cost is roughly constant per request, so
    a p99 far above p50 means requests sat in the queue waiting for a slot
    (capacity arrived too late or not at all)."""
    replica_events = [e for e in trace.events if e[0] == "replica"]
    if not replica_events or metrics is None:
        return None
    hist = metrics.histograms.get("serving/ttft_s")
    if hist is None or hist.total == 0:
        return None
    p50 = hist.percentile(0.50)
    p99 = hist.percentile(0.99)
    if p50 is None or p99 is None:
        return None
    floor = max(p50, 0.05)
    if p99 < 5.0 * floor:
        return None
    ups = sum(1 for e in trace.events
              if e[0] == "autoscale" and e[2] == "up")
    peak = max(
        (e[3].get("n_live", 0) for e in trace.events if e[0] == "autoscale"),
        default=0,
    )
    return Advisory(
        code="serving_queue_bound",
        severity=min(1.0, 0.4 + 0.06 * (p99 / floor)),
        summary=(
            f"serving queue bound: TTFT p99 {p99:.1f} s vs p50 {p50:.2f} s — "
            f"the tail is queueing for a slot, not prefill "
            f"({ups} alert-driven scale-up(s), peak fleet {peak})"
        ),
        recommendation=(
            "let capacity arrive earlier: raise max_replicas, shorten the "
            "scale-up cooldown, or lower the queue-delay alert's burn "
            "target/window so the burst trips it sooner"
        ),
        evidence={
            "ttft_p50_s": round(p50, 3),
            "ttft_p99_s": round(p99, 3),
            "scale_ups": ups,
            "peak_fleet": peak,
            "replica_events": len(replica_events),
        },
    )


def _check_pilot_underpacked(trace) -> Optional[Advisory]:
    """Pilots holding a whole node-block grant while most slots idle: the
    acquisition amortization the pilot exists for is not happening. Judged
    from the ``task_batch`` events' occupancy samples (>= 3 batches per
    pilot so a drain tail alone cannot trip it)."""
    occ: dict[str, list] = {}
    for kind, _t, label, args in trace.events:
        if kind == "task_batch":
            occ.setdefault(label, []).append(args.get("occupancy", 0.0))
    means = {
        name: sum(v) / len(v) for name, v in occ.items() if len(v) >= 3
    }
    under = sorted(
        ((m, name) for name, m in means.items() if m < 0.5)
    )
    if not under:
        return None
    worst_m, worst = under[0]
    return Advisory(
        code="pilot_underpacked",
        severity=min(1.0, 0.3 + 0.5 * (1.0 - worst_m)),
        summary=(
            f"pilot under-packed: {len(under)} of {len(means)} pilot(s) "
            f"averaged under 50% slot occupancy (worst {worst!r} at "
            f"{worst_m:.0%}) — the node-block grant is mostly idle"
        ),
        recommendation=(
            "submit more tasks per pilot, shrink n_compute/slots_per_node "
            "to match the backlog, or run the tail as plain jobs so the "
            "grant releases sooner"
        ),
        evidence={
            "worst_pilot": worst,
            "worst_mean_occupancy": round(worst_m, 4),
            "underpacked": [name for _m, name in under[:5]],
            "pilots_sampled": len(means),
        },
    )


def _check_slo_breach(slos) -> list[Advisory]:
    out = []
    for s in getattr(slos, "breached", ()):
        over = s.budget_consumed - 1.0
        out.append(
            Advisory(
                code="slo_breach",
                severity=min(1.0, 0.4 + 0.2 * over),
                summary=(
                    f"SLO {s.name!r} breached: attainment {s.attainment:.1%} "
                    f"vs objective {s.objective:.1%} (error budget "
                    f"{s.budget_consumed:.0%} spent)"
                ),
                recommendation=(
                    "treat the highest-burn window as the signal: the other "
                    "advisories name the bottleneck spending this budget"
                ),
                evidence={
                    "slo": s.name,
                    "objective": s.objective,
                    "attainment": round(s.attainment, 4),
                    "budget_consumed": round(s.budget_consumed, 4),
                    "burn_rates": s.burn_rates,
                },
            )
        )
    return out


# -- entry points -------------------------------------------------------------

def diagnose(trace, *, metrics=None, report=None, slos=None) -> tuple[Advisory, ...]:
    """Cross-reference one campaign's evidence into ranked advisories.

    ``trace`` is the campaign's :class:`~repro.obs.trace.TraceRecorder`;
    ``metrics``, the :class:`~repro.obs.metrics.MetricsHub` (falls back to
    ``trace.metrics``); ``report``, an optional
    :class:`~repro.orchestrator.metrics.CampaignReport` for pool stats;
    ``slos``, an optional :class:`~repro.obs.slo.SLOReport`. Returns
    advisories sorted most-severe first (empty tuple: nothing to flag).
    """
    if metrics is None:
        metrics = getattr(trace, "metrics", None)
    if slos is None and report is not None:
        slos = getattr(report, "slo", None)
    serving = _check_serving_queue_bound(trace, metrics)
    cp = critical_path(trace)
    if cp is None or cp.makespan_s <= 0:
        # span-free traces (serving campaigns) still get the serving check
        # and any SLO breaches; pure-empty traces stay an empty tuple
        if serving is None:
            return ()
        advisories = [serving]
        if slos is not None:
            advisories.extend(_check_slo_breach(slos))
        advisories.sort(key=lambda a: (-a.severity, a.code))
        return tuple(advisories)
    n_jobs = len(trace.spans)
    thrash = _check_pool_thrash(trace, n_jobs)
    found = [
        serving,
        thrash,
        _check_stage_in_bound(cp, trace, metrics, report, thrash is not None),
        _check_provisioning_bound(cp),
        _check_head_blocking(cp, trace),
        _check_fault_churn(trace, n_jobs),
        _check_node_churn(trace, n_jobs),
        _check_negotiation_pressure(trace),
        _check_pilot_underpacked(trace),
    ]
    advisories = [a for a in found if a is not None]
    if slos is not None:
        advisories.extend(_check_slo_breach(slos))
    advisories.sort(key=lambda a: (-a.severity, a.code))
    return tuple(advisories)


def format_advisories(advisories, *, max_n: int = 10) -> str:
    """Terminal rendering of the doctor's findings."""
    if not advisories:
        return "campaign doctor: nothing to flag"
    lines = [f"campaign doctor: {len(advisories)} advisories"]
    for i, a in enumerate(advisories[:max_n], 1):
        lines.append(f"  {i}. [{a.code}, severity {a.severity:.2f}]")
        lines.append(f"     {a.summary}")
        lines.append(f"     -> {a.recommendation}")
    return "\n".join(lines)
