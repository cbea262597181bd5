"""Cluster resource inventory: disks, storage nodes, compute nodes.

Mirrors the paper's two testbeds:

* **Dom** (Cray XC50): 8 compute nodes (2x18-core Broadwell, 64 GB DRAM) +
  4 DataWarp nodes, each with 3x 5.9 TB Samsung PM1725a PCIe SSDs
  (empirical 6.34 GB/s seq read, 3.2 GB/s seq write, measured with ``dd``
  and concurrent streams -- paper §IV-A). Global FS: Lustre, 2 OSTs, 170 TB.
* **Ault** (non-Cray): 1 node, 22-core Xeon Gold 6152, 16x Intel P4500 NVMe
  (vendor 3.2 GB/s read / 1.9 GB/s write; empirical-with-streams values are
  lower and captured in ``perfmodel``).

The same abstractions describe a TPU-pod hosting cluster: ``StorageNode`` is a
burst-buffer host on the pod's data-center network, ``ComputeNode`` a TPU host.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

GB = 1e9
TB = 1e12
MiB = 1 << 20
GiB = 1 << 30


@dataclasses.dataclass(frozen=True)
class DiskSpec:
    """A block-device model. Bandwidths are *empirical* multi-stream values."""

    model: str
    capacity_bytes: float
    read_bw: float           # B/s, sequential, concurrent streams
    write_bw: float          # B/s, sequential, concurrent streams
    iops_4k: float = 200e3   # small-IO ops/s, used for metadata targets
    latency_s: float = 80e-6

    def __post_init__(self) -> None:
        if self.capacity_bytes <= 0 or self.read_bw <= 0 or self.write_bw <= 0:
            raise ValueError(f"invalid DiskSpec: {self}")


# Paper-empirical devices (§IV-A, §IV-B).
PM1725A = DiskSpec("samsung-pm1725a", 5.9 * TB, read_bw=6.34 * GB, write_bw=3.2 * GB)
# Vendor numbers for the P4500 are 3.2/1.9 GB/s; with many concurrent streams
# the paper reached 20.36/13.70 GB/s aggregate over 5 storage + 2 md disks,
# i.e. ~2.9 GB/s read and ~2.9 GB/s write effective per storage disk once
# client-side effects are included; we keep vendor seq numbers and let the
# perfmodel's concurrency term handle the rest.
P4500 = DiskSpec("intel-p4500", 4.0 * TB, read_bw=3.2 * GB, write_bw=1.9 * GB)
# A contemporary profile for TPU-cluster burst-buffer hosts.
NVME_GEN4 = DiskSpec("nvme-gen4", 7.68 * TB, read_bw=7.0 * GB, write_bw=5.0 * GB)


@dataclasses.dataclass(frozen=True)
class Disk:
    """A concrete disk instance inside a node."""

    node_id: str
    index: int
    spec: DiskSpec

    @property
    def name(self) -> str:
        return f"{self.node_id}/nvme{self.index}n1"


@dataclasses.dataclass(frozen=True)
class InterconnectSpec:
    """Node-to-node network. Aries on Dom; DCN for TPU-cluster profile."""

    name: str
    node_bw: float            # B/s injection bandwidth per node
    latency_s: float = 1.5e-6


ARIES = InterconnectSpec("cray-aries", node_bw=10.0 * GB)
LOCAL_PCIE = InterconnectSpec("local-pcie", node_bw=64.0 * GB, latency_s=0.3e-6)
DCN_100G = InterconnectSpec("dcn-100g", node_bw=12.5 * GB, latency_s=5e-6)


@dataclasses.dataclass(frozen=True)
class StorageNode:
    """A node with local block storage (DataWarp node / burst-buffer host)."""

    node_id: str
    disks: tuple[Disk, ...]
    dram_bytes: float = 64 * GiB      # server-side cache ceiling (paper §IV-A2)
    constraint: str = "storage"       # the paper's SLURM constraint

    @property
    def n_disks(self) -> int:
        return len(self.disks)


@dataclasses.dataclass(frozen=True)
class ComputeNode:
    node_id: str
    cores: int = 36
    dram_bytes: float = 64 * GiB
    constraint: str = "mc"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Inventory handed to the scheduler."""

    name: str
    compute_nodes: tuple[ComputeNode, ...]
    storage_nodes: tuple[StorageNode, ...]
    interconnect: InterconnectSpec

    def storage_node(self, node_id: str) -> StorageNode:
        for n in self.storage_nodes:
            if n.node_id == node_id:
                return n
        raise KeyError(node_id)


def _mk_storage_nodes(
    prefix: str, count: int, disks_per_node: int, spec: DiskSpec, dram: float
) -> tuple[StorageNode, ...]:
    nodes = []
    for i in range(count):
        nid = f"{prefix}{i:03d}"
        disks = tuple(Disk(nid, d, spec) for d in range(disks_per_node))
        nodes.append(StorageNode(nid, disks, dram_bytes=dram))
    return tuple(nodes)


def dom_cluster() -> ClusterSpec:
    """The paper's Cray XC50 testbed (§IV-A)."""
    return ClusterSpec(
        name="dom",
        compute_nodes=tuple(ComputeNode(f"nid{i:05d}", cores=36) for i in range(8)),
        storage_nodes=_mk_storage_nodes("datawarp", 4, 3, PM1725A, 64 * GiB),
        interconnect=ARIES,
    )


def ault_cluster() -> ClusterSpec:
    """The paper's non-Cray portability testbed (§IV-B): storage is node-local,
    so the single node appears in both sets (the sets may overlap -- §III)."""
    return ClusterSpec(
        name="ault",
        compute_nodes=(ComputeNode("ault11", cores=22),),
        storage_nodes=_mk_storage_nodes("ault11-disks", 1, 16, P4500, 376 * GiB),
        interconnect=LOCAL_PCIE,
    )


def tpu_pod_cluster(n_hosts: int = 64, n_storage: int = 16) -> ClusterSpec:
    """A v5e-pod-scale profile: 64 TPU hosts + burst-buffer storage hosts."""
    return ClusterSpec(
        name="tpu-pod",
        compute_nodes=tuple(ComputeNode(f"host{i:04d}", cores=112) for i in range(n_hosts)),
        storage_nodes=_mk_storage_nodes("bb", n_storage, 4, NVME_GEN4, 512 * GiB),
        interconnect=DCN_100G,
    )


def synthetic_cluster(
    n_compute: int,
    n_storage: int,
    *,
    disks_per_node: int = 3,
    disk: DiskSpec = NVME_GEN4,
    name: str = "synthetic",
) -> ClusterSpec:
    """A parametric homogeneous inventory for scale benchmarks — e.g. the
    2,000-node cluster the 50k-job campaign bench sweeps. Node ids are
    zero-padded to five digits so lexicographic order (what the allocator
    grants by) equals numeric order at any size."""
    if n_compute <= 0 or n_storage <= 0:
        raise ValueError("synthetic_cluster needs positive node counts")
    storage = []
    for i in range(n_storage):
        nid = f"sn{i:05d}"
        disks = tuple(Disk(nid, d, disk) for d in range(disks_per_node))
        storage.append(StorageNode(nid, disks, dram_bytes=64 * GiB))
    return ClusterSpec(
        name=name,
        compute_nodes=tuple(ComputeNode(f"cn{i:05d}") for i in range(n_compute)),
        storage_nodes=tuple(storage),
        interconnect=DCN_100G,
    )


def aggregate_write_bw(nodes: Sequence[StorageNode], storage_disks_per_node: int) -> float:
    """Raw aggregate write bandwidth of the *storage-role* disks (paper's
    12.8 GB/s = 4 disks x 3.2 on two DataWarp nodes)."""
    return sum(
        sum(d.spec.write_bw for d in n.disks[:storage_disks_per_node])
        for n in nodes
    )


def flatten_disks(nodes: Iterable[StorageNode]) -> list[Disk]:
    return list(itertools.chain.from_iterable(n.disks for n in nodes))
