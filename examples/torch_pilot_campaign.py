"""Pilot campaign: two-level scheduling — 8 pilots, 40,000 tasks.

A mixed many-task campaign runs through `Orchestrator.submit_pilot`: each
pilot acquires a block of compute nodes plus ONE pooled storage session,
then the in-pilot `TaskScheduler` packs thousands of sub-node tasks into
its slots — wave packing, batch-priced I/O, coalesced completion batches.
A few plain jobs share the cluster to show both levels coexisting. The
pilot layer's walk is asserted end to end:

* **amortized acquisition** — exactly ONE negotiation and ONE pooled
  session per pilot, however many tasks stream through it;
* **packing** — every pilot runs more tasks than it has slots (the
  whole point of the bottom level), and the engine saw orders of
  magnitude fewer events than tasks;
* **task-level fault handling** — task faults retry inside the pilot
  (checkpoint-resumed) without a single global requeue;
* **observability** — per-pilot occupancy series land in the hub and
  the campaign dashboard renders alongside the usual lanes.

The dashboard lands in ``benchmarks/out/torch_pilot_dashboard.html`` — a single
self-contained file, no external requests.

Run:  PYTHONPATH=src python examples/torch_pilot_campaign.py
"""

import os
import time

from repro_torch.core import synthetic_cluster
from repro_torch.obs import MetricsHub, TraceRecorder
from repro_torch.obs.dashboard import write_dashboard
from repro_torch.orchestrator import (
    BackfillPolicy,
    JobState,
    Orchestrator,
    PilotSpec,
    TaskSpec,
    WorkflowSpec,
    format_report,
    summarize,
)
from repro_torch.pool import DatasetRef
from repro_torch.runtime import FaultInjector, FaultSpec

GB = 1e9
N_PILOTS = 8
TASKS_PER_PILOT = 5_000
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "out")


def main() -> None:
    cluster = synthetic_cluster(48, 12)
    datasets = [DatasetRef(f"shard{k}", (10.0 + 3.0 * k) * GB) for k in range(4)]

    hub = MetricsHub()
    rec = TraceRecorder(metrics=hub, sample_every_s=30.0)
    orch = Orchestrator(
        cluster, policy=BackfillPolicy(), recorder=rec,
        faults=FaultInjector(FaultSpec(task_fail_p=0.01, seed=17)),
    )
    orch.engine.SAMPLE_EVERY = 16
    orch.enable_pools(ttl_s=None).create_pool(nodes=4)

    jobs = []
    for i in range(N_PILOTS):
        task = TaskSpec(
            f"map{i}", run_time_s=20.0 + 5.0 * (i % 3), cores=0.125,
            stage_in_bytes=0.05 * GB, checkpoint_every_s=10.0,
        )
        jobs.append(orch.submit_pilot(
            PilotSpec(
                f"pilot{i}", n_compute=4, slots_per_node=8,
                datasets=(datasets[i % len(datasets)],),
                stage_in_bytes=1 * GB, completion_quantum_s=5.0,
            ),
            tasks=((task, TASKS_PER_PILOT),),
            at=i * 10.0,
        ))
    # a few plain jobs interleave on the same cluster: the two levels share
    # one scheduler, one pool subsystem, one report
    for i in range(6):
        jobs.append(orch.submit(WorkflowSpec(
            f"solo{i}", 2, use_pool=True,
            datasets=(datasets[i % len(datasets)],),
            run_time_s=120.0), at=30.0 + i * 20.0))

    t0 = time.perf_counter()
    orch.engine.run()
    wall = time.perf_counter() - t0

    rep = summarize(jobs, n_storage_nodes=len(cluster.storage_nodes),
                    pools=orch.pools, trace=rec)
    print(f"=== pilot campaign (simulated {rep.makespan_s:,.0f} s "
          f"in {wall * 1e3:.0f} ms) ===")
    print(format_report(rep, top_n=3))
    print()

    pilots = [j for j in jobs if j.pilot is not None]
    n_tasks = sum(j.pilot.stats.submitted for j in pilots)

    # -- amortized acquisition: ONE negotiation + ONE session per pilot ------
    n_sessions = rec.counts.get("sessions.opened.ephemeralfs", 0)
    n_negotiations = rec.counts.get("negotiation.scored", 0)
    assert n_sessions == len(jobs), (n_sessions, len(jobs))
    assert n_negotiations == len(jobs), (n_negotiations, len(jobs))
    assert rec.counts.get("pilot.started", 0) == N_PILOTS

    # -- packing: tasks far beyond the slot pool, events far below tasks -----
    for j in pilots:
        assert j.pilot.stats.submitted > j.pilot.tasks.base_slots, (
            f"{j.spec.name} did not pack beyond its slots"
        )
    batches = rec.counts.get("pilot.batches", 0)
    assert batches < n_tasks / 5, (
        f"{batches} completion batches for {n_tasks} tasks — not coalescing"
    )

    # -- task-level faults stayed inside the pilots --------------------------
    retries = sum(j.pilot.stats.retries for j in pilots)
    assert retries > 0, "fault injector never tripped a task"
    assert all(j.attempt == 0 for j in pilots), "a pilot requeued globally"
    assert all(j.state is JobState.DONE for j in jobs), "stragglers left"
    assert rep.tasks_done == n_tasks, (rep.tasks_done, n_tasks)

    # -- observability: per-pilot occupancy series + dashboard ---------------
    occ = hub.series.get("pilot_occupancy/pilot0")
    assert occ is not None and len(occ.items()) > 0

    os.makedirs(OUT_DIR, exist_ok=True)
    dash_path = os.path.join(OUT_DIR, "torch_pilot_dashboard.html")
    write_dashboard(dash_path, rec, metrics=hub, report=rep)
    assert os.path.getsize(dash_path) > 0

    saved = sum(j.pilot.stats.run_s_saved for j in pilots)
    print(f"pilots       : {N_PILOTS} x {TASKS_PER_PILOT:,} tasks "
          f"({n_tasks:,} total, {rep.tasks_done:,} done)")
    print(f"acquisitions : {n_sessions} sessions / {n_negotiations} "
          f"negotiations for {len(jobs)} jobs (1 per job, 0 per task)")
    print(f"batches      : {batches:,} coalesced completion batches "
          f"({n_tasks / max(batches, 1):,.0f} tasks per engine event)")
    print(f"task faults  : {retries} in-pilot retries, "
          f"{saved:,.0f} run-seconds saved by task checkpoints, "
          f"0 global requeues")
    print(f"dashboard    : {dash_path}")


if __name__ == "__main__":
    main()
