"""The port's campaign layers (``chaos/``, ``obs/``, ``pilot/``,
``orchestrator/``, ``serving/``) behaving as ``repro``'s on the same calls:
a seeded storage-node fault schedule, blast radii over live sessions and
pools, retry backoff and give-up on the virtual clock; a metrics hub's
series; a traced, SLO- and alert-watched campaign with its exports,
critical path, advisories and dashboard; pilots packing a seeded task bag;
campaigns under every queue policy (one with preemption and injected
faults); a pool-backed serving fleet under an autoscaler. Each scenario is
a function of the package name, runs once on each package and returns
plain data, compared with ``==``: the code is the same, so is the
answer."""

import dataclasses
import enum
import importlib

import pytest

pytest.importorskip("torch")

GB = 1e9


def _mods(name, *subs):
    return [importlib.import_module(f"{name}.{s}") for s in subs]


def plain(x):
    """``x`` as builtins only, so that two packages' objects compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    return x


def chaos_layer(name):
    """A seeded fault schedule over the Dom cluster's storage nodes, the
    blast radius of every node over live sessions and pools, and two retry
    trails on the engine's clock: one that succeeds, one that gives up."""
    core, chaos, orch, prov, pool = _mods(name, "core", "chaos", "orchestrator", "provision",
                                          "pool")
    cluster = core.dom_cluster()
    nodes = [n.node_id for n in cluster.storage_nodes]
    model = chaos.NodeFaultModel(nodes, mttf_s=4000.0, mttr_s=600.0, horizon_s=20_000.0,
                                 seed=5, schedule=((100.0, nodes[1]),))
    out = {"events": [(e.t, e.node_id, e.kind) for e in model.events()],
           "any": model.any_faults}

    svc = prov.ProvisioningService(cluster)
    mgr = svc.ensure_pools()
    pooled = svc.open_session(prov.StorageSpec("pool", nodes=2,
                                               lifetime=prov.LifetimeClass.PERSISTENT))
    lease = svc.open_session(prov.StorageSpec(
        "lease", lifetime=prov.LifetimeClass.POOLED,
        datasets=(pool.DatasetRef("tiles", 20 * GB),), stage_in_bytes=1 * GB))
    mirror = svc.open_session(prov.StorageSpec("mirror", nodes=2, managers=("ephemeralfs",),
                                               placement=prov.Placement(mirror=True)))
    sessions = (lease, mirror)
    for nid in nodes:
        br = chaos.resolve_blast_radius(nid, sessions=sessions, pools=mgr.live_pools)
        out[nid] = {"sessions": [s.spec.name for s in br.sessions],
                    "pools": [p.pool_id for p in br.pools], "leases": len(br.leases),
                    "empty": br.empty}
    out["pool_nodes"] = sorted(pooled.pool.storage_node_ids)

    policy = chaos.RetryPolicy(max_attempts=4, base_s=10.0, factor=3.0, max_delay_s=60.0,
                               jitter=0.2, seed=3)
    eng = orch.SimEngine()
    calls = {"ok": [], "never": []}
    gave = []
    chaos.drive_retries(eng, policy, "ok",
                        lambda: (calls["ok"].append(eng.now), len(calls["ok"]) >= 3)[1])
    chaos.drive_retries(eng, policy, "never",
                        lambda: (calls["never"].append(eng.now), False)[1],
                        give_up=lambda: gave.append(eng.now))
    eng.run()
    out["retry"] = {"delays": [policy.delays(k) for k in ("ok", "never")], "calls": calls,
                    "gave_up": gave,
                    "deadline": chaos.RetryPolicy(base_s=10.0, deadline_s=100.0,
                                                  seed=1).delays("x")}
    return out


def metrics_hub(name):
    """Counters, gauges, a histogram, recorded series and probes sampled on
    a clock; their snapshot, percentiles and windowed aggregates."""
    (obs,) = _mods(name, "obs")
    hub = obs.MetricsHub()
    depth = [0.0]
    hub.add_probe("depth", lambda: depth[0])
    h = hub.histogram("wait_s")
    for t in range(40):
        depth[0] = (t * 7) % 11
        hub.counter("arrivals").inc(1 + t % 3)
        hub.gauge("busy").set(t % 5)
        h.observe(0.5 * ((t * 13) % 17))
        hub.record("rate", float(t), 0.25 * (t % 9))
        hub.sample(float(t) * 10.0)
    series = hub.series["depth"]
    return {"snapshot": hub.snapshot(), "short": hub.snapshot(max_points=8),
            "p": [h.percentile(q) for q in (0.5, 0.9, 0.99)], "mean": h.mean,
            "window": series.window(100.0, 250.0), "last": series.last(),
            "samples": hub.samples_taken}


def traced_campaign(name):
    """A seeded 30-job campaign on the Dom cluster, traced, under an SLO
    tracker and an alert engine, with an injected fault burst: the trace's
    records and Chrome trace, the critical path, the SLO report, the alert
    incidents, the doctor's advisories and the dashboard."""
    core, obs, orch_m, prov, rt = _mods(name, "core", "obs", "orchestrator", "provision",
                                        "runtime")
    cluster = core.dom_cluster()
    hub = obs.MetricsHub()
    slos = obs.SLOTracker(hub, [
        obs.SLOSpec(name="queue-delay-p99", histogram="phase_s/queued", percentile=0.99,
                    op="<=", target=600.0, objective=0.75, burn_windows=(300.0, 1800.0)),
        obs.SLOSpec(name="depth", series="queue_depth", percentile=0.95, window_s=600.0,
                    op="<=", target=20.0, objective=0.9),
    ])
    alerts = obs.AlertEngine(hub, [
        obs.AlertRule(name="failed", kind="rate", series="jobs_failed", op=">=",
                      target=0.004, window_s=240.0, severity="critical"),
        obs.AlertRule(name="backlog", kind="threshold", series="queue_depth", op=">=",
                      target=10.0, for_s=120.0),
        obs.AlertRule(name="burn", kind="burn", slo="queue-delay-p99", op=">=", target=2.0,
                      window_s=300.0),
    ], slos=slos)
    rec = obs.TraceRecorder(metrics=hub, sample_every_s=30.0, alerts=alerts)
    orch = orch_m.Orchestrator(cluster, policy=orch_m.BackfillPolicy(),
                               faults=rt.FaultInjector(rt.FaultSpec(stage_in_fail_p=0.02,
                                                                    seed=7)),
                               recorder=rec)
    orch.engine.SAMPLE_EVERY = 16
    specs = [orch_m.WorkflowSpec(
        name=f"ingest{i:02d}", n_compute=1 + i % 2,
        storage_spec=prov.StorageSpec(f"ingest{i:02d}", nodes=1 + i % 2,
                                      stage_in_bytes=(60.0 + 20.0 * (i % 3)) * GB,
                                      stage_out_bytes=2.0 * GB),
        run_time_s=12.0 + 3.0 * (i % 4), max_retries=0 if i % 2 == 0 else 2)
        for i in range(30)]
    arrivals = orch_m.poisson_arrivals(rate_per_s=0.2, n=len(specs), seed=7)
    orch.run_campaign(specs, submit_times=arrivals, until=60.0)
    orch.faults = rt.FaultInjector(rt.FaultSpec(stage_in_fail_p=0.8, run_fail_p=0.3, seed=7))
    orch.run_campaign(until=200.0)
    orch.faults = rt.FaultInjector(rt.FaultSpec(stage_in_fail_p=0.02, seed=7))
    jobs = orch.run_campaign()
    report = orch_m.summarize(jobs, n_storage_nodes=len(cluster.storage_nodes), trace=rec)
    cp = obs.critical_path(rec)
    advisories = obs.diagnose(rec, report=report)
    return {
        "records": list(obs.jsonl_records(rec)),
        "chrome": obs.chrome_trace(rec, hub),
        "counts": dict(rec.counts),
        "critical_path": obs.format_critical_path(cp, max_segments=12),
        "cp": plain(cp),
        "slo": obs.format_slo_report(slos.report()),
        "incidents": [(i.rule, i.t_fired, i.t_resolved) for i in alerts.incidents],
        "alerts": obs.format_alerts(alerts),
        "advisories": [str(a) for a in advisories],
        "advice": obs.format_advisories(advisories),
        "report": plain(report), "report_text": orch_m.format_report(report, top_n=3),
        "dashboard": obs.build_dashboard(rec, report=report, advisories=advisories,
                                         title="traced campaign"),
        "text": obs.format_dashboard(rec, report=report, advisories=advisories),
    }


def pilot_campaign(name):
    """Three pilots packing a seeded bag of checkpointed tasks beside plain
    jobs on one pool-backed cluster, task faults injected: each pilot's
    ``TaskStats`` and the campaign's rollups."""
    core, orch_m, pilot, pool, rt = _mods(name, "core", "orchestrator", "pilot", "pool",
                                          "runtime")
    cluster = core.synthetic_cluster(16, 4)
    orch = orch_m.Orchestrator(cluster, policy=orch_m.BackfillPolicy(),
                               faults=rt.FaultInjector(rt.FaultSpec(task_fail_p=0.02,
                                                                    seed=17)))
    orch.enable_pools(ttl_s=None).create_pool(nodes=2)
    datasets = [pool.DatasetRef(f"shard{k}", (10.0 + 3.0 * k) * GB) for k in range(2)]
    jobs = []
    for i in range(3):
        task = pilot.TaskSpec(f"map{i}", run_time_s=20.0 + 5.0 * i, cores=0.125,
                              stage_in_bytes=0.05 * GB, checkpoint_every_s=10.0)
        jobs.append(orch.submit_pilot(
            pilot.PilotSpec(f"pilot{i}", n_compute=2, slots_per_node=8,
                            datasets=(datasets[i % 2],), stage_in_bytes=1 * GB,
                            completion_quantum_s=5.0),
            tasks=((task, 400),), at=i * 10.0))
    for i in range(3):
        jobs.append(orch.submit(orch_m.WorkflowSpec(f"solo{i}", 2, use_pool=True,
                                                    datasets=(datasets[i % 2],),
                                                    run_time_s=120.0), at=20.0 + i * 15.0))
    orch.engine.run()
    rep = orch_m.summarize(jobs, n_storage_nodes=len(cluster.storage_nodes), pools=orch.pools)
    return {"stats": [plain(j.pilot.stats) for j in jobs if j.pilot is not None],
            "states": [j.state.name for j in jobs], "report": orch_m.format_report(rep),
            "live": plain(orch_m.live_report(orch.counters,
                                             n_storage_nodes=len(cluster.storage_nodes),
                                             now=orch.engine.now))}


def _campaign_specs(orch_m, prov, pool, pooled):
    datasets = [pool.DatasetRef(f"d{k}", (15.0 + 5.0 * k) * GB) for k in range(3)]
    specs = []
    for i in range(36):
        if pooled and i % 3 == 0:
            storage = prov.StorageSpec(f"j{i:02d}", lifetime=prov.LifetimeClass.POOLED,
                                       datasets=(datasets[i % 3], datasets[(i + 1) % 3]),
                                       stage_in_bytes=1 * GB, stage_out_bytes=1 * GB)
        else:
            storage = prov.StorageSpec(f"j{i:02d}", nodes=1 + i % 2,
                                       stage_in_bytes=(5.0 + i % 4) * GB,
                                       stage_out_bytes=1 * GB)
        specs.append(orch_m.WorkflowSpec(f"j{i:02d}", 1 + i % 4, storage_spec=storage,
                                         run_time_s=40.0 + 15.0 * (i % 5),
                                         checkpoint_every_s=20.0, priority=i % 3))
    return specs


def orchestrated(policy):
    def scenario(name):
        """36 Poisson arrivals on the Dom cluster under ``policy``; the
        data-aware one with a persistent pool on two of its four storage
        nodes; the preemptive one with
        injected stage-in and run faults: the report, its text, the live
        counters and the pool report."""
        core, orch_m, prov, pool, rt = _mods(name, "core", "orchestrator", "provision",
                                             "pool", "runtime")
        cluster = core.dom_cluster()
        kw = {}
        if policy == "preempt":
            kw = dict(preemption=orch_m.PreemptionPolicy(),
                      faults=rt.FaultInjector(rt.FaultSpec(stage_in_fail_p=0.05,
                                                           run_fail_p=0.05, seed=11)))
        orch = orch_m.Orchestrator(cluster, **kw)
        pooled = policy == "data-aware"
        if pooled:
            orch.enable_pools(ttl_s=1500.0)
            orch.provision.open_session(prov.StorageSpec(
                "pool", nodes=2, lifetime=prov.LifetimeClass.PERSISTENT,
                capacity_cap_bytes=60.0 * GB))
        orch.policy = {"fifo": orch_m.FIFOPolicy, "backfill": orch_m.BackfillPolicy,
                       "easy": orch_m.EasyBackfillPolicy,
                       "storage-aware": orch_m.StorageAwarePolicy,
                       "preempt": orch_m.FIFOPolicy,
                       "data-aware": lambda: orch_m.DataAwarePolicy(orch.provision)}[policy]()
        arrivals = orch_m.poisson_arrivals(rate_per_s=0.3, n=36, seed=13)
        jobs = orch.run_campaign(_campaign_specs(orch_m, prov, pool, pooled),
                                 submit_times=arrivals)
        n = len(cluster.storage_nodes)
        rep = orch_m.summarize(jobs, n_storage_nodes=n, pools=orch.pools)
        return {"report": plain(rep), "text": orch_m.format_report(rep, top_n=5),
                "live": plain(orch_m.live_report(orch.counters, n_storage_nodes=n,
                                                 now=orch.engine.now)),
                "pool": plain(orch_m.pool_report(orch.pools)) if pooled else None,
                "history": [[(s.name, t) for s, t in j.history] for j in jobs]}
    scenario.__name__ = f"orchestrated_{policy}"
    return scenario


def serving_fleet(name):
    """A pool-backed serving fleet under diurnal traffic and a burst, an
    autoscaler driven by a queue-delay burn alert: the serving report and
    the fleet's scale events."""
    core, obs, orch_m, serving = _mods(name, "core", "obs", "orchestrator", "serving")
    times = sorted(orch_m.diurnal_arrivals(500, base_rate=0.4, peak_rate=1.6, period_s=1200.0,
                                           seed=11)
                   + orch_m.burst_arrivals(220, base_rate=0.05, burst_rate=6.0, burst_t0=400.0,
                                           burst_t1=520.0, seed=12))
    requests = serving.synthesize_requests(times, seed=13)
    model = serving.ModelProfile("sim-14b", weight_bytes=28 * GB, n_slots=8)
    hub = obs.MetricsHub()
    slos = obs.SLOTracker(hub, [obs.SLOSpec(name="queue-delay",
                                            series="serving/queue_delay_s", op="<=",
                                            target=2.0, objective=0.85,
                                            burn_windows=(120.0, 600.0))])
    alerts = obs.AlertEngine(hub, [obs.AlertRule(name="burn", kind="burn", slo="queue-delay",
                                                 op=">=", target=3.0, window_s=120.0)],
                             slos=slos)
    rec = obs.TraceRecorder(metrics=hub, sample_every_s=10.0, alerts=alerts)
    scaler = serving.Autoscaler(alerts, serving.AutoscalerConfig(
        rule="burn", min_replicas=1, max_replicas=4, control_every_s=15.0,
        scale_up_cooldown_s=60.0, idle_ttl_s=90.0), recorder=rec)
    camp = serving.ServingCampaign(core.dom_cluster(), model, requests, initial_replicas=1,
                                   autoscaler=scaler, recorder=rec)
    report = camp.run()
    return {"report": plain(report), "text": serving.format_serving_report(report),
            "scale": plain(camp.rset.scale_events),
            "incidents": [(i.rule, i.t_fired, i.t_resolved) for i in alerts.incidents],
            "requests": [(r.queue_delay_s, r.ttft_s, r.e2e_s) for r in requests]}


ORCH_POLICIES = ("fifo", "backfill", "easy", "storage-aware", "data-aware", "preempt")
SCENARIOS = {f.__name__: f for f in (
    chaos_layer, metrics_hub, traced_campaign, pilot_campaign, serving_fleet,
    *(orchestrated(p) for p in ORCH_POLICIES))}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_campaign_layer_behaves_as_repro(scenario):
    got = SCENARIOS[scenario]("repro_torch")
    want = SCENARIOS[scenario]("repro")
    assert got == want


def test_scenarios_see_what_they_are_for():
    """Each scenario reaches the behaviour it is there to compare."""
    c = chaos_layer("repro_torch")
    assert {k for _, _, k in c["events"]} == {"down", "up"}
    hit = [v for k, v in c.items() if k.startswith(("nid", "sn", "datawarp"))
           and isinstance(v, dict) and not v["empty"]]
    assert any(v["pools"] and v["leases"] for v in hit)
    assert any("mirror" in v["sessions"] for v in hit)
    assert len(c["retry"]["calls"]["ok"]) == 3 and len(c["retry"]["gave_up"]) == 1
    t = traced_campaign("repro_torch")
    assert t["records"] and t["incidents"] and t["advisories"]
    assert t["dashboard"].lower().startswith("<!doctype html>")
    p = pilot_campaign("repro_torch")
    assert all(s["done"] > 16 and s["retries"] >= 0 for s in p["stats"])
    assert sum(s["retries"] for s in p["stats"]) > 0
    s = serving_fleet("repro_torch")
    assert s["report"]["n_completed"] == s["report"]["n_requests"]
    assert s["report"]["scale_ups"] >= 1 and s["report"]["scale_downs"] >= 1
    assert s["incidents"]
    runs = {p: orchestrated(p)("repro_torch")["report"] for p in ORCH_POLICIES}
    assert all(r["n_done"] == r["n_jobs"] == 36 for r in runs.values())
    assert runs["preempt"]["preemptions"] > 0 and runs["preempt"]["total_retries"] > 0
    assert runs["data-aware"]["stage_in_bytes_saved"] > 0
