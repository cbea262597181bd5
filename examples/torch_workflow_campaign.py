"""Workflow campaign: 150 jobs through the event-driven orchestrator.

The paper's pipeline — allocate compute+storage, deploy the on-demand FS,
stage in, run, stage out, tear down — executed as a *campaign* over the
unified StorageSession API: every job states its storage demand as a
declarative `StorageSpec` (sizing by nodes, capacity, or bandwidth;
preferred data managers with ordered fallbacks; QoS floors), and the
orchestrator's `ProvisioningService` negotiates each one onto the best
feasible backend — the BeeGFS-analogue ephemeral FS, the always-on global
FS (zero deploy latency, shared bandwidth), or the KV store. Jobs queue and
backfill when the 4 DataWarp nodes are busy; a fault injector trips some
provisioning and staging attempts, which requeue and retry with a warm
redeploy. Virtual time advances by perfmodel predictions; wallclock stays
in milliseconds.

Run:  PYTHONPATH=src python examples/torch_workflow_campaign.py
"""

import time

from repro_torch.core import dom_cluster
from repro_torch.orchestrator import (
    BackfillPolicy,
    FIFOPolicy,
    Orchestrator,
    StorageAwarePolicy,
    WorkflowSpec,
    format_report,
    summarize,
)
from repro_torch.provision import QoS, StorageSpec
from repro_torch.runtime import FaultInjector, FaultSpec

GB = 1e9


def make_specs(n_jobs: int = 150) -> list[WorkflowSpec]:
    """A mixed campaign: small analysis jobs, zero-deploy postprocessing,
    KV-backed feature extraction, mid-size simulations, and a few
    storage-hungry checkpoint-heavy runs."""
    specs = []
    for i in range(n_jobs):
        kind = i % 10
        if kind < 4:        # small: capacity-sized with a real global-FS
            spec = WorkflowSpec(  # fallback (capacity fits either backend)
                name=f"analysis{i:03d}",
                n_compute=1 + i % 2,
                storage_spec=StorageSpec(
                    f"analysis{i:03d}",
                    capacity_bytes=5e12,                      # -> 1 node
                    managers=("ephemeralfs", "globalfs"),
                    stage_in_bytes=4 * GB,
                    stage_out_bytes=1 * GB,
                ),
                run_time_s=30.0 + 10.0 * (i % 4),
            )
        elif kind < 6:      # postprocessing: needs storage *now* -> the
            spec = WorkflowSpec(  # zero-deploy shared FS wins negotiation
                name=f"post{i:03d}",
                n_compute=1,
                storage_spec=StorageSpec(
                    f"post{i:03d}",
                    capacity_bytes=1e12,
                    managers=("globalfs", "ephemeralfs"),
                    qos=QoS(max_provision_s=1.0),
                    stage_in_bytes=2 * GB,
                    stage_out_bytes=1 * GB,
                ),
                run_time_s=20.0 + 5.0 * (i % 3),
            )
        elif kind < 7:      # feature extraction into an ephemeral KV store
            spec = WorkflowSpec(
                name=f"features{i:03d}",
                n_compute=2,
                storage_spec=StorageSpec(
                    f"features{i:03d}",
                    nodes=1,
                    access="kv",
                    stage_in_bytes=8 * GB,
                ),
                run_time_s=40.0,
            )
        elif kind < 9:      # medium: capacity-sized request (paper §V)
            spec = WorkflowSpec(
                name=f"sim{i:03d}",
                n_compute=4,
                storage_spec=StorageSpec(
                    f"sim{i:03d}",
                    capacity_bytes=14e12,                     # -> 2 nodes
                    managers=("ephemeralfs",),
                    stage_in_bytes=60 * GB,
                    stage_out_bytes=20 * GB,
                ),
                run_time_s=120.0,
            )
        else:               # large: bandwidth-sized with a QoS floor
            spec = WorkflowSpec(
                name=f"ckpt{i:03d}",
                n_compute=8,
                storage_spec=StorageSpec(
                    f"ckpt{i:03d}",
                    bandwidth=18e9,                           # -> 3 nodes
                    managers=("ephemeralfs",),
                    qos=QoS(min_bandwidth=18e9),
                    stage_in_bytes=200 * GB,
                    stage_out_bytes=120 * GB,
                ),
                run_time_s=300.0,
            )
        specs.append(spec)
    return specs


def main() -> None:
    cluster = dom_cluster()     # 8 compute + 4 DataWarp storage nodes
    faults = lambda: FaultInjector(          # noqa: E731
        FaultSpec(provision_fail_p=0.03, stage_in_fail_p=0.02, run_fail_p=0.01, seed=7)
    )

    for policy in (FIFOPolicy(), BackfillPolicy(), StorageAwarePolicy(aging_s=2000)):
        orch = Orchestrator(cluster, policy=policy, faults=faults())
        t0 = time.perf_counter()
        jobs = orch.run_campaign(make_specs())
        wall = time.perf_counter() - t0
        rep = summarize(jobs, n_storage_nodes=len(cluster.storage_nodes))
        stats = orch.provision.stats
        print(f"=== policy: {policy.name} "
              f"(simulated {rep.makespan_s:,.0f} s in {wall * 1e3:.0f} ms) ===")
        print(format_report(rep, top_n=5))
        by_backend = ", ".join(
            f"{k}={v}" for k, v in sorted(stats.sessions_opened.items())
        )
        print(f"negotiated sessions: {by_backend} "
              f"({stats.negotiations} negotiations, "
              f"{stats.negotiation_wall_s * 1e3:.1f} ms total)")
        print()


if __name__ == "__main__":
    main()
