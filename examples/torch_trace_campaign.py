"""Traced campaign: record everything, export a Perfetto timeline, and
profile the critical path.

A mixed 80-job campaign on dom's 8+4 nodes — pooled shared-dataset
analysis jobs, ephemeral-FS simulations with checkpoint commits, and a
seeded fault injector tripping staging/run attempts — runs with a
:class:`~repro.obs.TraceRecorder` and :class:`~repro.obs.MetricsHub`
attached. The trace lands in three forms:

* ``benchmarks/out/torch_trace_campaign.json`` — Chrome trace-event JSON; open
  it at https://ui.perfetto.dev (one track per job / backend / pool,
  spans per lifecycle phase, flow arrows on fault->requeue, counter
  tracks from the metrics hub);
* ``benchmarks/out/torch_trace_campaign.jsonl`` — one flat record per span /
  session / event for ad-hoc ``jq``-style analysis;
* stdout — the campaign report with the critical-path breakdown:
  which phases the makespan was actually spent on, walked backward
  through the grant-enablement chain.

The script asserts what the trace export must hold: the export is
valid JSON, and the critical-path phase totals sum to the makespan
exactly.

Run:  PYTHONPATH=src python examples/torch_trace_campaign.py
"""

import json
import os
import time

from repro_torch.core import dom_cluster
from repro_torch.obs import (
    MetricsHub,
    TraceRecorder,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.orchestrator import (
    BackfillPolicy,
    Orchestrator,
    WorkflowSpec,
    format_report,
    poisson_arrivals,
    summarize,
)
from repro_torch.pool import DatasetRef
from repro_torch.provision import LifetimeClass, StorageSpec
from repro_torch.runtime import FaultInjector, FaultSpec

GB = 1e9
N_JOBS = 80
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "out")


def make_specs(datasets):
    """Pooled analysis + checkpointing simulations + KV feature jobs."""
    specs = []
    for i in range(N_JOBS):
        kind = i % 5
        name = f"job{i:03d}"
        if kind < 2:        # pooled shared-dataset analysis
            spec = WorkflowSpec(
                name=name,
                n_compute=1 + i % 2,
                storage_spec=StorageSpec(
                    name,
                    lifetime=LifetimeClass.POOLED,
                    datasets=(datasets[i % len(datasets)],),
                    stage_in_bytes=2 * GB,
                    stage_out_bytes=1 * GB,
                ),
                run_time_s=30.0 + 10.0 * (i % 3),
            )
        elif kind < 4:      # checkpoint-heavy ephemeral-FS simulation
            spec = WorkflowSpec(
                name=name,
                n_compute=2 + i % 3,
                storage_spec=StorageSpec(
                    name,
                    nodes=1 + i % 2,
                    managers=("ephemeralfs",),
                    stage_in_bytes=30 * GB,
                    stage_out_bytes=10 * GB,
                ),
                run_time_s=120.0 + 20.0 * (i % 4),
                max_retries=3,
                checkpoint_every_s=40.0,
                checkpoint_bytes=2 * GB,
            )
        else:               # feature extraction into the KV store
            spec = WorkflowSpec(
                name=name,
                n_compute=1,
                storage_spec=StorageSpec(
                    name,
                    nodes=1,
                    access="kv",
                    stage_in_bytes=6 * GB,
                ),
                run_time_s=45.0,
            )
        specs.append(spec)
    return specs


def main() -> None:
    cluster = dom_cluster()
    datasets = [DatasetRef(f"tile{k}", (15.0 + 5.0 * k) * GB) for k in range(4)]

    hub = MetricsHub()
    rec = TraceRecorder(metrics=hub, sample_every_s=60.0)
    orch = Orchestrator(
        cluster,
        policy=BackfillPolicy(),
        faults=FaultInjector(
            FaultSpec(stage_in_fail_p=0.04, run_fail_p=0.03, seed=11)
        ),
        recorder=rec,
    )
    orch.enable_pools(ttl_s=1500.0)
    for k in range(2):      # persistent pools backing the POOLED jobs
        orch.provision.open_session(
            StorageSpec(
                f"tile-pool{k}",
                nodes=1,
                lifetime=LifetimeClass.PERSISTENT,
                capacity_cap_bytes=80.0 * GB,
            )
        )
    # a short campaign never reaches the default 512-event metronome
    # stride; sample often enough for visible counter tracks
    orch.engine.SAMPLE_EVERY = 64

    t0 = time.perf_counter()
    jobs = orch.run_campaign(
        make_specs(datasets),
        submit_times=poisson_arrivals(rate_per_s=0.4, n=N_JOBS, seed=11),
    )
    wall = time.perf_counter() - t0

    # -- report + critical path (summarize folds the trace in) ---------------
    rep = summarize(jobs, n_storage_nodes=len(cluster.storage_nodes),
                    pools=orch.pools, trace=rec)
    print(f"=== traced campaign (simulated {rep.makespan_s:,.0f} s "
          f"in {wall * 1e3:.0f} ms) ===")
    print(format_report(rep, top_n=3))
    print()

    cp = rep.critical_path
    gap = abs(sum(cp.phase_s.values()) - cp.makespan_s)
    assert gap < 1e-6, f"critical-path phases off makespan by {gap}"

    # -- exports --------------------------------------------------------------
    os.makedirs(OUT_DIR, exist_ok=True)
    trace_path = os.path.join(OUT_DIR, "torch_trace_campaign.json")
    jsonl_path = os.path.join(OUT_DIR, "torch_trace_campaign.jsonl")
    write_chrome_trace(trace_path, rec, metrics=hub)
    write_jsonl(jsonl_path, rec)

    with open(trace_path) as fh:          # the artifact must be valid JSON
        doc = json.load(fh)
    events = doc["traceEvents"]
    assert events and all("ph" in e and "pid" in e for e in events)
    with open(jsonl_path) as fh:
        n_records = sum(1 for line in fh if json.loads(line))

    print(f"chrome trace : {trace_path} ({len(events)} events) "
          f"-- open at https://ui.perfetto.dev")
    print(f"jsonl        : {jsonl_path} ({n_records} records)")
    print(f"trace counts : {dict(sorted(rec.counts.items()))}")
    print(f"metrics      : {hub.samples_taken} samples over "
          f"{len(hub.series)} series")


if __name__ == "__main__":
    main()
