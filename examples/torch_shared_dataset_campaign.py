"""Shared-dataset campaign: persistent pools vs per-job provisioning.

An oversubscribed campaign — 120 jobs over 8 shared datasets on dom's 4
DataWarp nodes, arriving as a Poisson process — run twice, both through the
unified StorageSession API (`StorageSpec` -> `ProvisioningService`):

* **per-job** (the paper's mechanism): every job's spec has EPHEMERAL
  lifetime — negotiation grants fresh storage nodes, deploys a BeeGFS,
  stages *all* of its input datasets from Lustre, and tears everything down
  at job end. Shared data crosses the wire once per referencing job.
* **pooled + data-aware**: two PERSISTENT sessions create long-lived pools
  that pin the storage nodes once; jobs carry POOLED specs, so negotiation
  resolves them to capacity *leases*, `DataAwarePolicy` routes them to the
  pool already holding their inputs, and stage-in moves only cache misses.
  Capped pool ledgers put the LRU eviction engine under pressure; idle
  pools are reaped after a TTL once the queue drains.

Run:  PYTHONPATH=src python examples/torch_shared_dataset_campaign.py
"""

import time

from repro_torch.core import dom_cluster
from repro_torch.orchestrator import (
    BackfillPolicy,
    DataAwarePolicy,
    Orchestrator,
    WorkflowSpec,
    format_report,
    poisson_arrivals,
    summarize,
)
from repro_torch.pool import DatasetRef
from repro_torch.provision import LifetimeClass, StorageSpec

GB = 1e9
N_JOBS = 120
N_DATASETS = 8


def make_datasets() -> list[DatasetRef]:
    """<= 10 shared datasets, 15-30 GB each (climatology tiles, say)."""
    return [
        DatasetRef(f"tile{k:02d}", (15.0 + 5.0 * (k % 4)) * GB)
        for k in range(N_DATASETS)
    ]


def make_specs(datasets: list[DatasetRef], *, pooled: bool) -> list[WorkflowSpec]:
    specs = []
    for i in range(N_JOBS):
        picks = sorted({i % N_DATASETS, (i * i + 1) % (N_DATASETS // 2)})
        name = f"analysis{i:03d}"
        if pooled:
            storage = StorageSpec(
                name,
                lifetime=LifetimeClass.POOLED,
                datasets=tuple(datasets[k] for k in picks),
                stage_in_bytes=2 * GB,     # private inputs
                stage_out_bytes=1 * GB,    # results
            )
        else:
            storage = StorageSpec(
                name,
                nodes=1 + i % 2,
                managers=("ephemeralfs",),
                datasets=tuple(datasets[k] for k in picks),
                stage_in_bytes=2 * GB,
                stage_out_bytes=1 * GB,
            )
        specs.append(
            WorkflowSpec(
                name=name,
                n_compute=1 + i % 3,
                storage_spec=storage,
                run_time_s=25.0 + 5.0 * (i % 5),
            )
        )
    return specs


def main() -> None:
    cluster = dom_cluster()
    arrivals = poisson_arrivals(rate_per_s=0.5, n=N_JOBS, seed=13)

    # --- per-job provisioning (the paper's job-scoped mechanism) ------------
    datasets = make_datasets()
    base = Orchestrator(cluster, policy=BackfillPolicy())
    t0 = time.perf_counter()
    base_jobs = base.run_campaign(
        make_specs(datasets, pooled=False), submit_times=arrivals
    )
    base_wall = time.perf_counter() - t0
    base_rep = summarize(base_jobs, n_storage_nodes=len(cluster.storage_nodes))
    print(f"=== per-job provisioning (simulated {base_rep.makespan_s:,.0f} s "
          f"in {base_wall * 1e3:.0f} ms) ===")
    print(format_report(base_rep, top_n=3))
    print()

    # --- persistent pools + data-aware routing -------------------------------
    orch = Orchestrator(cluster)
    orch.enable_pools(ttl_s=2000.0)     # idle pools reaped after TTL
    svc = orch.provision
    for k in range(2):
        svc.open_session(
            StorageSpec(
                f"tile-pool{k}",
                nodes=2,
                lifetime=LifetimeClass.PERSISTENT,
                capacity_cap_bytes=110.0 * GB,
            )
        )
    orch.policy = DataAwarePolicy(svc)
    t0 = time.perf_counter()
    jobs = orch.run_campaign(make_specs(datasets, pooled=True),
                             submit_times=arrivals)
    wall = time.perf_counter() - t0
    rep = summarize(jobs, n_storage_nodes=len(cluster.storage_nodes),
                    pools=orch.pools)
    print(f"=== pooled + data-aware (simulated {rep.makespan_s:,.0f} s "
          f"in {wall * 1e3:.0f} ms) ===")
    print(format_report(rep, top_n=3))
    print()

    saved = rep.stage_in_bytes_saved
    print(f"stage-in traffic: {base_rep.staged_in_bytes / GB:,.0f} GB per-job vs "
          f"{rep.staged_in_bytes / GB:,.0f} GB pooled "
          f"({saved / base_rep.staged_in_bytes:.0%} of baseline saved)")
    print(f"makespan: {base_rep.makespan_s:,.0f} s per-job vs "
          f"{rep.makespan_s:,.0f} s pooled")
    print(f"pools left live after TTL reap: {len(orch.pools.live_pools)}")


if __name__ == "__main__":
    main()
