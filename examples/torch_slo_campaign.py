"""SLO-guarded campaign: objectives, a mid-campaign fault burst, alerts,
the campaign doctor, and a self-contained HTML dashboard.

A 100-job stage-in-heavy campaign runs on dom's 8+4 nodes with the full
active observability layer attached:

* four :class:`~repro.obs.SLOSpec` objectives — queue-delay p99 (over the
  trace's per-phase histogram), queue-depth p95 (windowed series
  quantile), stage-in cache hit-rate floor, and a compute-utilization
  floor — accounted per metronome sample on the **virtual** clock;
* an :class:`~repro.obs.AlertEngine` with threshold, rate-of-change, and
  SLO burn-rate rules. Midway through the campaign a fault burst is
  injected (the stage-in failure probability jumps for 10 virtual
  minutes): the failed-job growth-rate alert must trip, then resolve when
  the burst passes;
* the campaign doctor (:func:`~repro.obs.diagnose`), which must identify
  the campaign as **stage-in bound** (the specs stage tens of GB per job
  against a 4-node storage partition on purpose);
* :func:`~repro.obs.write_dashboard` — a single static HTML file with
  inline SVG sparklines, the SLO/error-budget table, the alert timeline,
  and the doctor's advisories: no scripts, no external requests.

The script asserts each of those outcomes, so it doubles as an
integration check in CI.

Run:  PYTHONPATH=src python examples/torch_slo_campaign.py
"""

import os

from repro_torch.core import dom_cluster
from repro_torch.obs import (
    AlertEngine,
    AlertRule,
    MetricsHub,
    SLOSpec,
    SLOTracker,
    TraceRecorder,
    diagnose,
    format_dashboard,
    write_dashboard,
)
from repro_torch.orchestrator import (
    BackfillPolicy,
    Orchestrator,
    WorkflowSpec,
    format_report,
    poisson_arrivals,
    summarize,
)
from repro_torch.provision import StorageSpec
from repro_torch.runtime import FaultInjector, FaultSpec

GB = 1e9
N_JOBS = 100
BURST_T0, BURST_T1 = 500.0, 1_100.0        # virtual fault-burst window
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "out")
DASHBOARD = os.path.join(OUT_DIR, "torch_slo_dashboard.html")

CALM = FaultSpec(stage_in_fail_p=0.01, seed=7)
BURST = FaultSpec(stage_in_fail_p=0.85, run_fail_p=0.3, seed=7)


def make_specs():
    """Stage-in-heavy ephemeral jobs: tens of GB in, a short compute burst
    out — the shape that makes a campaign stage-in bound. Every other job
    is no-retry, so a fault during the burst is a terminal failure the
    ``jobs_failed`` rate alert can see (retried jobs just re-queue and
    land after the burst has passed)."""
    return [
        WorkflowSpec(
            name=f"ingest{i:03d}",
            n_compute=1 + i % 2,
            storage_spec=StorageSpec(
                f"ingest{i:03d}",
                nodes=1 + i % 2,
                stage_in_bytes=(100.0 + 20.0 * (i % 3)) * GB,
                stage_out_bytes=2.0 * GB,
            ),
            run_time_s=12.0 + 3.0 * (i % 4),
            max_retries=0 if i % 2 == 0 else 2,
        )
        for i in range(N_JOBS)
    ]


def make_slos(hub):
    return SLOTracker(
        hub,
        [
            SLOSpec(
                name="queue-delay-p99",
                histogram="phase_s/queued",
                percentile=0.99,
                op="<=",
                target=2_500.0,
                objective=0.75,
                burn_windows=(600.0, 3600.0),
                description="p99 time-in-queue stays under ~42 min",
            ),
            SLOSpec(
                name="queue-depth-p95",
                series="queue_depth",
                percentile=0.95,
                window_s=900.0,
                op="<=",
                target=95.0,
                objective=0.9,
                description="windowed p95 backlog stays bounded",
            ),
            SLOSpec(
                name="stage-in-hit-rate",
                series="catalog_hit_rate",
                op=">=",
                target=0.25,
                objective=0.5,
                description="a quarter of dataset lookups should be warm",
            ),
            SLOSpec(
                name="compute-utilization",
                series="free_compute_nodes",
                op="<=",
                target=7.0,
                objective=0.6,
                description="at least one compute node is busy mid-campaign",
            ),
        ],
    )


def make_alerts(hub, slos):
    return AlertEngine(
        hub,
        [
            AlertRule(
                name="failed-jobs-growth",
                kind="rate",
                series="jobs_failed",
                op=">=",
                target=0.008,               # jobs failing per virtual second
                window_s=240.0,
                severity="critical",
                description="terminal failures are accumulating",
            ),
            AlertRule(
                name="queue-backlog",
                kind="threshold",
                series="queue_depth",
                op=">=",
                target=85.0,
                for_s=240.0,
                severity="warning",
            ),
            AlertRule(
                name="queue-delay-burn",
                kind="burn",
                slo="queue-delay-p99",
                op=">=",
                target=4.0,                 # 4x sustainable budget spend
                window_s=600.0,
                severity="critical",
            ),
        ],
        slos=slos,
    )


def main() -> None:
    cluster = dom_cluster()
    hub = MetricsHub()
    slos = make_slos(hub)
    alerts = make_alerts(hub, slos)
    rec = TraceRecorder(metrics=hub, sample_every_s=30.0, alerts=alerts)
    orch = Orchestrator(
        cluster,
        policy=BackfillPolicy(),
        faults=FaultInjector(CALM),
        recorder=rec,
    )
    # a small campaign under-runs the 512-event metronome stride; sample
    # often enough that the alert engine sees the burst while it is live
    orch.engine.SAMPLE_EVERY = 32

    # -- run with a fault burst injected mid-campaign -------------------------
    arrivals = poisson_arrivals(rate_per_s=0.25, n=N_JOBS, seed=7)
    orch.run_campaign(make_specs(), submit_times=arrivals, until=BURST_T0)
    orch.faults = FaultInjector(BURST)      # swap injectors on the live run
    orch.run_campaign(until=BURST_T1)
    orch.faults = FaultInjector(CALM)
    jobs = orch.run_campaign()              # drain to completion

    report = summarize(
        jobs, n_storage_nodes=len(cluster.storage_nodes), trace=rec
    )
    print(format_report(report, top_n=3))
    print()

    # -- the fault burst must have tripped (and resolved) the rate alert ------
    incidents = alerts.incidents_for("failed-jobs-growth")
    assert incidents, "fault burst never tripped the failed-jobs-growth alert"
    first = incidents[0]
    assert first.t_fired >= BURST_T0, (
        f"alert fired at {first.t_fired:.0f}s, before the burst began"
    )
    assert not first.open, "alert never resolved after the burst passed"
    alert_events = [e for e in rec.events if e[0] == "alert"]
    assert alert_events, "alert lifecycle transitions missing from the trace"

    # -- SLO accounting rode the virtual clock --------------------------------
    assert report.slo is not None and slos.samples_taken == alerts.evaluations
    assert report.slo.status("stage-in-hit-rate").breached, (
        "no pools are attached, so the hit-rate SLO must be breached"
    )

    # -- the doctor must call the campaign stage-in bound ---------------------
    advisories = diagnose(rec, report=report)
    codes = [a.code for a in advisories]
    assert "stage_in_bound" in codes, f"doctor said {codes}"
    top_structural = next(a for a in advisories if a.code != "slo_breach")
    assert top_structural.code == "stage_in_bound", (
        f"top structural advisory was {top_structural.code}"
    )

    # -- dashboard: one file, zero external requests, no scripts --------------
    os.makedirs(OUT_DIR, exist_ok=True)
    write_dashboard(DASHBOARD, rec, report=report, advisories=advisories,
                    title="SLO campaign, dom 8+4")
    with open(DASHBOARD, encoding="utf-8") as fh:
        doc = fh.read()
    low = doc.lower()
    assert low.startswith("<!doctype html>")
    assert "<script" not in low, "dashboard must not carry scripts"
    assert "http" not in low, "dashboard must not reference the network"
    assert "<svg" in low and "slo" in low

    print(format_dashboard(rec, report=report, advisories=advisories))
    print()
    print(f"dashboard    : {DASHBOARD} ({len(doc):,} bytes, self-contained)")
    print(f"alerts       : {len(alerts.incidents)} incidents, "
          f"{alerts.pending_cancelled} flaps suppressed, "
          f"{alerts.evaluations} evaluations")
    print(f"top advisory : {advisories[0]}")


if __name__ == "__main__":
    main()
