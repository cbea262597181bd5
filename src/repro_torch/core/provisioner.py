"""Provisioner: turns a storage allocation into a running data manager
(paper §III-C: container started with Shifter on each storage node; an
entry-point script renders per-service config files and starts daemons).

The functional deployment instantiates :class:`EphemeralFS`; the deployment
*time* is modeled (C8: 5.37 s over 2 DataWarp nodes on Dom; 4.6 s fresh /
1.2 s warm over 8 local disks on Ault).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Literal, Optional

from .client import FSClient
from .datamanager import FSError
from .ephemeralfs import EphemeralFS
from .perfmodel import FSDeployment, predict_deploy_time
from .resources import ClusterSpec, StorageNode
from .scheduler import Allocation, SizingPolicy
from .striping import DEFAULT_STRIPE


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    """Rendered 'container + entrypoint config' for one job's storage."""

    storage_nodes: tuple[StorageNode, ...]
    md_disks_per_node: int = 1
    storage_disks_per_node: int = 2
    stripe_size: int = DEFAULT_STRIPE
    mirror: bool = False
    runtime: Literal["shifter", "docker"] = "shifter"
    image: str = "cscs/beegfs-ondemand:7.1"

    @property
    def targets_per_node(self) -> int:
        return self.md_disks_per_node + self.storage_disks_per_node

    @property
    def n_storage_targets(self) -> int:
        return self.storage_disks_per_node * len(self.storage_nodes)

    def render_service_config(self) -> dict:
        """The paper's entrypoint python script writes beegfs-{mgmtd,meta,
        storage,mon}.conf per node; we render the equivalent dict."""
        mgmt_node = self.storage_nodes[0].node_id
        cfg: dict = {
            "mgmtd": {"node": mgmt_node, "port": 8008},
            "mon": {"node": mgmt_node, "port": 8009},
            "meta": [],
            "storage": [],
        }
        for node in self.storage_nodes:
            for d in range(self.md_disks_per_node):
                cfg["meta"].append(
                    {
                        "node": node.node_id,
                        "store": f"/mnt/nvme{d}n1/meta",
                        "mgmtd": mgmt_node,
                        "xattr": True,
                    }
                )
            for d in range(self.md_disks_per_node, self.targets_per_node):
                cfg["storage"].append(
                    {
                        "node": node.node_id,
                        "store": f"/mnt/nvme{d}n1/storage",
                        "mgmtd": mgmt_node,
                    }
                )
        return cfg


@dataclasses.dataclass
class Deployment:
    """A live, job-scoped data manager."""

    plan: DeploymentPlan
    fs: EphemeralFS
    model: FSDeployment              # analytic view for the perfmodel
    deploy_time_s: float             # modeled (C8)
    wallclock_deploy_s: float        # actual in-container time (functional)
    base_dir: str
    provisioner: Optional["Provisioner"] = None   # owner of the tree registry

    def mount(self, client_id: str = "client0") -> FSClient:
        return FSClient(self.fs, client_id)

    def teardown(self) -> None:
        """Kill services and delete the tree; the base_dir becomes claimable
        (and cold) again."""
        self.fs.teardown()
        if self.provisioner is not None:
            self.provisioner.release_tree(self.base_dir)

    def release(self, *, keep_tree: bool = False) -> None:
        """Stop the data manager; with ``keep_tree`` the on-disk tree stays,
        so the next deploy into the same base_dir takes the warm (§IV-B1
        1.2 s) path instead of the fresh one."""
        self.fs.teardown(keep_data=keep_tree)
        if self.provisioner is not None:
            self.provisioner.release_tree(self.base_dir)


class Provisioner:
    """Deploys a data manager on the storage nodes of an allocation."""

    def __init__(self, cluster: ClusterSpec, policy: SizingPolicy | None = None):
        self.cluster = cluster
        self.policy = policy or SizingPolicy()
        # warm-tree cache: base dirs we have deployed into before (paper
        # §IV-B1: re-deploying over an existing tree takes 1.2 s vs 4.6 s).
        self._seen_trees: set[str] = set()
        # collision guard: base dirs currently owned by a live deployment or
        # pool. Two live sessions must never share a tree (they would
        # silently serve each other's data as a "warm" cache).
        self._live_dirs: dict[str, str] = {}
        # analytic models are pure functions of a plan's shape; campaigns
        # re-plan the same shapes thousands of times, so canonicalize
        self._model_cache: dict[tuple, FSDeployment] = {}

    # -- base_dir ownership ---------------------------------------------------
    def claim_tree(self, base_dir: str, owner: str = "deployment") -> None:
        """Register ``base_dir`` as owned by a live deployment/pool; raises
        :class:`FSError` on collision instead of silently sharing the tree."""
        holder = self._live_dirs.get(base_dir)
        if holder is not None:
            raise FSError(
                f"base_dir {base_dir!r} is already in use by live "
                f"deployment {holder!r}; release it before redeploying"
            )
        self._live_dirs[base_dir] = owner

    def release_tree(self, base_dir: str) -> None:
        """Drop live ownership of ``base_dir`` (teardown/retire path)."""
        self._live_dirs.pop(base_dir, None)

    def tree_owner(self, base_dir: str) -> Optional[str]:
        return self._live_dirs.get(base_dir)

    def plan_for(
        self,
        alloc: Allocation,
        *,
        mirror: bool = False,
        stripe_size: int = DEFAULT_STRIPE,
        md_disks_per_node: Optional[int] = None,
        storage_disks_per_node: Optional[int] = None,
        runtime: Literal["shifter", "docker"] = "shifter",
    ) -> DeploymentPlan:
        if not alloc.storage_nodes:
            raise FSError("allocation has no storage nodes")
        return self.plan_for_nodes(
            alloc.storage_nodes,
            mirror=mirror,
            stripe_size=stripe_size,
            md_disks_per_node=md_disks_per_node,
            storage_disks_per_node=storage_disks_per_node,
            runtime=runtime,
        )

    def plan_for_nodes(
        self,
        storage_nodes: tuple[StorageNode, ...],
        *,
        mirror: bool = False,
        stripe_size: int = DEFAULT_STRIPE,
        md_disks_per_node: Optional[int] = None,
        storage_disks_per_node: Optional[int] = None,
        runtime: Literal["shifter", "docker"] = "shifter",
    ) -> DeploymentPlan:
        """Plan a deployment over an explicit node set (no Allocation needed).

        The persistent-pool subsystem plans its long-lived file systems this
        way: the pool holds the nodes through its own scheduler allocation
        and re-plans (warm) deployments over the same set across leases.
        """
        if not storage_nodes:
            raise FSError("no storage nodes to plan over")
        return DeploymentPlan(
            storage_nodes=tuple(storage_nodes),
            md_disks_per_node=(
                md_disks_per_node
                if md_disks_per_node is not None
                else self.policy.metadata_disks_per_node
            ),
            storage_disks_per_node=(
                storage_disks_per_node
                if storage_disks_per_node is not None
                else self.policy.storage_disks_per_node
            ),
            stripe_size=stripe_size,
            mirror=mirror,
            runtime=runtime,
        )

    def is_warm(self, base_dir: str) -> bool:
        """Would a deploy into ``base_dir`` take the warm (1.2 s) path?"""
        return base_dir in self._seen_trees and os.path.isdir(base_dir)

    def forget_tree(self, base_dir: str) -> None:
        """Drop a tree from the warm cache (pool retirement / eviction of a
        pool-resident tree): the next deploy over it pays the fresh cost."""
        self._seen_trees.discard(base_dir)

    def model_for(self, plan: DeploymentPlan) -> FSDeployment:
        """The analytic (perfmodel) view of a plan -- no disk I/O.

        Used by the workflow orchestrator's event-driven engine, which runs
        whole provisioning campaigns against modeled time only. Models are
        canonicalized (one shared frozen instance per plan shape), so
        same-shape deployments across a campaign hit one cache entry.
        """
        node0 = plan.storage_nodes[0]
        key = (
            len(plan.storage_nodes),
            plan.n_storage_targets,
            plan.md_disks_per_node,
            node0.disks[plan.md_disks_per_node].spec,
            node0.dram_bytes,
        )
        cached = self._model_cache.get(key)
        if cached is not None:
            return cached
        self._model_cache[key] = model = FSDeployment(
            kind="ephemeral",
            n_nodes=len(plan.storage_nodes),
            storage_targets=plan.n_storage_targets,
            md_targets=plan.md_disks_per_node * len(plan.storage_nodes),
            disk=node0.disks[plan.md_disks_per_node].spec,
            node_dram=node0.dram_bytes,
            net=self.cluster.interconnect,
            local_client=self.cluster.name == "ault",
        )
        return model

    def deploy(self, plan: DeploymentPlan, base_dir: Optional[str] = None) -> Deployment:
        base_dir = base_dir or tempfile.mkdtemp(prefix="efs-")
        self.claim_tree(base_dir)
        fresh = base_dir not in self._seen_trees or not os.path.isdir(base_dir)
        t0 = time.perf_counter()
        try:
            plan.render_service_config()      # the entrypoint work
            fs = EphemeralFS(
                plan.storage_nodes,
                base_dir,
                md_disks_per_node=plan.md_disks_per_node,
                storage_disks_per_node=plan.storage_disks_per_node,
                stripe_size=plan.stripe_size,
                mirror=plan.mirror,
            )
        except Exception:
            # a failed deploy never produced a Deployment whose teardown
            # could release the claim — drop it here or the dir is
            # undeployable forever
            self.release_tree(base_dir)
            raise
        wall = time.perf_counter() - t0
        self._seen_trees.add(base_dir)
        model = self.model_for(plan)
        t_model = predict_deploy_time(
            plan.targets_per_node, runtime=plan.runtime, fresh=fresh
        )
        return Deployment(
            plan=plan,
            fs=fs,
            model=model,
            deploy_time_s=t_model,
            wallclock_deploy_s=wall,
            base_dir=base_dir,
            provisioner=self,
        )
