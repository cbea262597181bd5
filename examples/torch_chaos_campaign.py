"""Chaos campaign: storage-node kills, degraded mirrors, self-healing pools.

A 40-job campaign (mirrored ephemeral-FS simulations + pooled
shared-dataset analysis) runs under a scripted `NodeFaultModel`: one kill
hits a pool's backing node, one hits nodes under mirrored deployments,
and both repair MTTR later. The chaos layer's whole walk is
asserted end to end:

* **kill** — both scripted node_down events fire and the scheduler's
  healthy-capacity fraction (the ``availability`` gauge) dips below 1;
* **degraded** — at least one mirrored deployment survives its node loss
  DEGRADED (halved bandwidth) instead of dying;
* **rebuild** — the damaged pool heals (a backfilled spare on the
  `RetryPolicy` backoff, or re-silvered on the node's own repair), its
  ledger capacity restored exactly;
* **resolve** — after the repairs, availability returns to 1.0, every
  job completes, and the campaign dashboard renders the node-outage lane
  alongside the availability sparkline.

The dashboard lands in ``benchmarks/out/torch_chaos_dashboard.html`` — a single
self-contained file, no external requests.

Run:  PYTHONPATH=src python examples/torch_chaos_campaign.py
"""

import os
import time

from repro_torch.chaos import NodeFaultModel, RetryPolicy
from repro_torch.core import synthetic_cluster
from repro_torch.obs import MetricsHub, TraceRecorder
from repro_torch.obs.dashboard import write_dashboard
from repro_torch.orchestrator import (
    BackfillPolicy,
    JobState,
    Orchestrator,
    WorkflowSpec,
    format_report,
    summarize,
)
from repro_torch.pool import DatasetRef
from repro_torch.provision import LifetimeClass, Placement, StorageSpec

GB = 1e9
N_JOBS = 40
MTTR_S = 420.0
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "out")


def make_specs(datasets):
    specs = []
    for i in range(N_JOBS):
        name = f"job{i:03d}"
        if i % 4 == 0:      # pooled shared-dataset analysis
            storage = StorageSpec(
                name,
                lifetime=LifetimeClass.POOLED,
                datasets=(datasets[i % len(datasets)],),
                stage_in_bytes=1 * GB,
                stage_out_bytes=1 * GB,
            )
        else:               # mirrored simulation: survives one node loss
            storage = StorageSpec(
                name,
                nodes=2,
                managers=("ephemeralfs",),
                placement=Placement(mirror=True),
                stage_in_bytes=(8.0 + 2.0 * (i % 5)) * GB,
                stage_out_bytes=2 * GB,
            )
        specs.append(
            WorkflowSpec(
                name,
                1 + i % 4,
                storage_spec=storage,
                run_time_s=90.0 + 15.0 * (i % 4),
                max_retries=5,
            )
        )
    return specs


def main() -> None:
    cluster = synthetic_cluster(24, 8)
    datasets = [DatasetRef(f"tile{k}", (12.0 + 4.0 * k) * GB) for k in range(4)]

    hub = MetricsHub()
    rec = TraceRecorder(metrics=hub, sample_every_s=30.0)
    orch = Orchestrator(cluster, policy=BackfillPolicy(), recorder=rec)
    orch.engine.SAMPLE_EVERY = 16          # short campaign: sample densely
    orch.enable_pools(ttl_s=None)
    pool_session = orch.provision.open_session(
        StorageSpec(
            "tile-pool",
            nodes=2,
            lifetime=LifetimeClass.PERSISTENT,
            capacity_cap_bytes=90.0 * GB,
        )
    )
    pool = pool_session.pool
    pool_node = sorted(pool.storage_node_ids)[1]

    # the chaos schedule: one kill into the pool, one into the mirrored
    # fleet, repairs MTTR later — all bulk-scheduled, fully deterministic
    model = NodeFaultModel(
        [n.node_id for n in cluster.storage_nodes],
        mttr_s=MTTR_S,
        schedule=((180.0, pool_node), (300.0, "sn00005")),
    )
    orch.enable_chaos(model, retry=RetryPolicy(base_s=20.0, seed=9))

    t0 = time.perf_counter()
    jobs = orch.run_campaign(
        make_specs(datasets), submit_times=[i * 4.0 for i in range(N_JOBS)]
    )
    wall = time.perf_counter() - t0

    rep = summarize(jobs, n_storage_nodes=len(cluster.storage_nodes),
                    pools=orch.pools, trace=rec)
    print(f"=== chaos campaign (simulated {rep.makespan_s:,.0f} s "
          f"in {wall * 1e3:.0f} ms) ===")
    print(format_report(rep, top_n=3))
    print()

    # -- kill: both scripted outages fired, availability dipped --------------
    assert rec.counts.get("chaos.node_downs", 0) == 2, rec.counts
    assert rec.counts.get("chaos.node_repairs", 0) == 2, rec.counts
    avail = hub.series["availability"]
    lows = [v for _, v in avail.items() if v < 1.0]
    assert lows and min(lows) <= 0.875, "availability never dipped"

    # -- degraded: a mirrored deployment survived its node loss --------------
    n_degraded = rec.counts.get("chaos.degraded", 0)
    assert n_degraded > 0, "no deployment degraded"

    # -- rebuild: the pool healed and its ledger capacity is whole -----------
    assert rec.counts.get("chaos.rebuilds", 0) >= 1, "pool never rebuilt"
    assert not pool.dead_node_capacity, "pool still degraded at campaign end"

    # -- resolve: full health, every job done --------------------------------
    assert orch.scheduler.healthy_capacity_fraction == 1.0
    assert avail.last()[1] == 1.0, f"availability gauge stuck at {avail.last()}"
    assert all(j.state is JobState.DONE for j in jobs), "stragglers left"

    os.makedirs(OUT_DIR, exist_ok=True)
    dash_path = os.path.join(OUT_DIR, "torch_chaos_dashboard.html")
    write_dashboard(dash_path, rec, metrics=hub, report=rep)
    with open(dash_path) as fh:
        html = fh.read()
    assert "node outages" in html, "dashboard lost the node-event lane"
    assert "availability" in html, "dashboard lost the availability sparkline"

    print(f"node kills   : 2 (pool node {pool_node} at t=180s, "
          f"sn00005 at t=300s; repaired +{MTTR_S:.0f}s)")
    print(f"degraded     : {n_degraded} mirrored deployment(s) survived")
    print(f"rebuilds     : {rec.counts['chaos.rebuilds']} "
          f"(replaced={sorted(pool.replaced_node_ids) or 'repaired in place'})")
    print(f"requeued     : {rec.counts.get('fault.requeued', 0)} attempts "
          f"through checkpoint-resume")
    print(f"availability : dipped to {min(lows):.2f}, recovered to "
          f"{avail.last()[1]:.2f}")
    print(f"dashboard    : {dash_path}")


if __name__ == "__main__":
    main()
