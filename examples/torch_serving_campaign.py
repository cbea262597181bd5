"""Serving campaign: a flash crowd, an alert, an autoscaler, a drain.

A pool-backed model fleet serves a diurnal request trace on dom's 8+4
nodes. Midway through, a traffic burst overwhelms the single warm replica:

1. model weights (28 GB) stage **once** into a PERSISTENT pool; the
   replica attaches a POOLED lease and pages them in (every later attach
   is a pure catalog hit — asserted from the trace);
2. the burst builds a queue; the ``queue-delay`` SLO starts burning error
   budget and the ``queue-delay-burn`` alert goes FIRING;
3. the :class:`~repro.serving.Autoscaler` consumes the incident and
   scales up — warm lease attach + perfmodel-priced page-in, no deploy;
4. the backlog clears, the alert RESOLVES, and idle-TTL drains the fleet
   back to one replica (the pool keeps the weights resident);
5. the campaign doctor reads the span-free serving trace and the HTML
   dashboard renders it — script-free, network-free.

The script asserts each outcome, so it doubles as a CI integration check.

Run:  PYTHONPATH=src python examples/torch_serving_campaign.py
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
    write_dashboard,
)
from repro_torch.orchestrator import burst_arrivals, diurnal_arrivals
from repro_torch.serving import (
    Autoscaler,
    AutoscalerConfig,
    ModelProfile,
    ServingCampaign,
    format_serving_report,
    synthesize_requests,
)

GB = 1e9
BURST_T0, BURST_T1 = 400.0, 520.0
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "out")
DASHBOARD = os.path.join(OUT_DIR, "torch_serving_dashboard.html")


def main() -> None:
    times = sorted(
        diurnal_arrivals(500, base_rate=0.4, peak_rate=1.6,
                         period_s=1_200.0, seed=11)
        + burst_arrivals(220, base_rate=0.05, burst_rate=6.0,
                         burst_t0=BURST_T0, burst_t1=BURST_T1, seed=12)
    )
    requests = synthesize_requests(times, seed=13)
    model = ModelProfile("qwen3-14b-sim", weight_bytes=28 * GB, n_slots=8)

    hub = MetricsHub()
    slos = SLOTracker(
        hub,
        [
            SLOSpec(
                name="queue-delay",
                series="serving/queue_delay_s",
                op="<=",
                target=2.0,
                objective=0.85,
                burn_windows=(120.0, 600.0),
                description="head-of-queue wait stays bounded",
            )
        ],
    )
    alerts = AlertEngine(
        hub,
        [
            AlertRule(
                name="queue-delay-burn",
                kind="burn",
                slo="queue-delay",
                op=">=",
                target=3.0,
                window_s=120.0,
                severity="critical",
                description="queue-delay error budget burning 3x too fast",
            )
        ],
        slos=slos,
    )
    rec = TraceRecorder(metrics=hub, sample_every_s=10.0, alerts=alerts)
    autoscaler = Autoscaler(
        alerts,
        AutoscalerConfig(
            rule="queue-delay-burn",
            min_replicas=1,
            max_replicas=4,
            control_every_s=15.0,
            scale_up_cooldown_s=60.0,
            idle_ttl_s=90.0,
        ),
        recorder=rec,
    )
    camp = ServingCampaign(
        dom_cluster(), model, requests,
        initial_replicas=1, autoscaler=autoscaler, recorder=rec,
    )
    report = camp.run()
    print(format_serving_report(report))
    print()

    # -- the burst must have tripped (and resolved) the burn alert ------------
    incidents = alerts.incidents_for("queue-delay-burn")
    assert incidents, "burst never tripped the queue-delay-burn alert"
    first = incidents[0]
    assert first.t_fired >= BURST_T0, (
        f"alert fired at {first.t_fired:.0f}s, before the burst began"
    )
    assert not first.open, "alert never resolved after the backlog cleared"

    # -- the autoscaler consumed the incident: grow, then drain ---------------
    assert report.scale_ups >= 1, "FIRING alert never scaled the fleet up"
    assert report.scale_downs >= 1, "RESOLVED + idle TTL never drained"
    assert report.n_replicas_final == 1, (
        f"fleet ended at {report.n_replicas_final} replicas, expected 1"
    )
    actions = [e[1] for e in camp.rset.scale_events if e[1] in ("up", "down")]
    assert actions.index("up") < len(actions) - 1 - actions[::-1].index("down")

    # -- weights staged exactly once; replica attaches are warm ---------------
    attaches = [e for e in rec.events if e[0] == "lease_attached"]
    misses = [e for e in attaches if e[3]["misses"] > 0]
    assert len(misses) == 1 and misses[0][2] == "serving-weights", (
        f"expected exactly the loader lease to miss, got {misses}"
    )
    pm = camp.service.pool_manager
    assert pm.stats.bytes_staged == model.weight_bytes

    # -- every request served -------------------------------------------------
    assert report.n_completed == len(requests)

    # -- doctor reads the span-free serving trace -----------------------------
    advisories = diagnose(rec)
    codes = [a.code for a in advisories]
    assert "serving_queue_bound" in codes, f"doctor said {codes}"

    # -- dashboard: one file, zero external requests, no scripts --------------
    os.makedirs(OUT_DIR, exist_ok=True)
    write_dashboard(DASHBOARD, rec, advisories=advisories,
                    title="Serving campaign, dom 8+4")
    with open(DASHBOARD, encoding="utf-8") as fh:
        doc = fh.read()
    low = doc.lower()
    assert low.startswith("<!doctype html>")
    assert "<script" not in low, "dashboard must not carry scripts"
    assert "http" not in low, "dashboard must not reference the network"

    print(f"alert        : fired {first.t_fired:,.0f}s, "
          f"resolved {first.t_resolved:,.0f}s "
          f"(burst was [{BURST_T0:,.0f}, {BURST_T1:,.0f}]s)")
    print(f"fleet        : {report.scale_ups} up / {report.scale_downs} down, "
          f"peak {report.peak_replicas}, "
          f"{report.replica_seconds:,.0f} replica-seconds")
    print(f"weights      : staged once ({model.weight_bytes / GB:.0f} GB), "
          f"{len(attaches) - 1} warm replica attaches")
    print(f"top advisory : {advisories[0]}")
    print(f"dashboard    : {DASHBOARD} ({len(doc):,} bytes, self-contained)")


if __name__ == "__main__":
    main()
