"""Calibrated analytic performance model for the provisioned storage stack.

This container has no Aries network, PM1725a SSDs, or 288 MPI ranks, so paper
-scale timing cannot be *measured*; it is *modeled*. The functional layer
(`ephemeralfs`, `globalfs`) moves real bytes and proves correctness; this
module predicts bandwidth/latency at the paper's scale from first principles
plus a small set of calibration constants, each tied to a paper observation
(C1..C9 in DESIGN.md §1).

Model structure
---------------
* **Write path**: raw aggregate disk bandwidth x pattern efficiency, with a
  fixed setup overhead that produces the small-size ramp of Figs. 2-3.
  Shared-file efficiency depends on deployment size (chunk-allocation
  serialization on one file object -- calibrated from Fig. 4's logarithmic
  scaling); file-per-process efficiency is flat ~0.93 (C3: "the file system
  is being used at the maximum of its capability").
* **Read path (write-then-read, as IOR runs)**: if the per-node working set
  fits the server DRAM cache, reads are network-bound (cache-served);
  otherwise LRU sequential read-back yields ~zero hits (the tail evicts the
  head before it is read) and reads fall to a cache-thrash disk path --
  the sharp collapse of Fig. 2 at >= 512 MB/proc (C2).
* **Unaligned shared writes** (HACC-IO's 38-byte AoS records): BeeGFS takes a
  moderate penalty (no range locks on its write path); Lustre collapses
  (stripe-lock ping-pong across 288 writers on 2 OSTs) -- C7.
* **Metadata**: per-(fs, op) rate tables calibrated from Tables I-II,
  scaled by metadata-target count; BeeGFS dir-stat is client-cache-served
  (the paper's own explanation of the anomalous 5.3M op/s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

from .resources import (
    ARIES,
    GB,
    GiB,
    LOCAL_PCIE,
    MiB,
    DiskSpec,
    InterconnectSpec,
    P4500,
    PM1725A,
)

Pattern = Literal["shared", "fpp"]
Op = Literal["write", "read"]

# --------------------------------------------------------------------------
# Empirical multi-stream device profiles (paper §IV-A / §IV-B: vendor numbers
# "do not reflect a real use-case with multiple concurrent streams").
# --------------------------------------------------------------------------
PM1725A_STREAMS = dataclasses.replace(PM1725A)  # paper already gives empirical 6.34/3.2
P4500_STREAMS = dataclasses.replace(P4500, read_bw=4.3 * GB, write_bw=2.93 * GB)

# --------------------------------------------------------------------------
# Calibration constants (source in comment)
# --------------------------------------------------------------------------
# C3: FPP peak 11.96 GB/s over 4x3.2 raw = 0.934.
EFS_FPP_WRITE_EFF = 0.934
# Fig. 4 shared-file write scaling: ~2.36 GB/s @1 node, 7.01 @2, ~9.1 @4
# over raw 6.4/12.8/25.6 -> efficiency by *storage-target* count.
EFS_SHARED_WRITE_EFF = {2: 0.37, 4: 0.548, 8: 0.356}
# Cache-served reads are network-bound with these pattern efficiencies
# (C7 read 9.1 GB/s over 2x10 GB/s Aries injection = 0.455).
EFS_SHARED_READ_EFF = 0.455
EFS_FPP_READ_EFF = 0.55
# C2: cache-thrash read path (eviction interference + random-ish chunk order).
EFS_THRASH_READ_EFF = 0.10
# Fraction of node DRAM actually usable as server cache (OS + daemons).
EFS_CACHE_USABLE_FRAC = 0.85
# C7: HACC unaligned shared write on BeeGFS: 5.3 GB/s vs aligned 7.01.
EFS_UNALIGNED_WRITE_FACTOR = 0.78
# Fixed setup overheads producing the small-size ramp (writes pay chunk
# allocation; reads are cheap to start on BeeGFS, expensive on Lustre where
# the MDS+OST lock round-trips dominate small read-backs -- Fig. 2's
# "even more with 4MB per process" read advantage).
EFS_SHARED_SETUP_S = 0.35
EFS_FPP_SETUP_S = 0.15
EFS_READ_SETUP_S = 0.05

# Lustre (2 OSTs on Dom reach ~6 GB/s write; read ~ half of BeeGFS's 9).
LUSTRE_OST_WRITE_BW = 3.0 * GB
LUSTRE_OST_READ_BW = 2.3 * GB
LUSTRE_SETUP_S = 0.05          # fast, dedicated MDS
LUSTRE_READ_SETUP_S = 0.30
# C7: 288 writers with 38-byte records on 2 OSTs: <=1 GB/s write, <0.4 read.
LUSTRE_UNALIGNED_WRITE_EFF = 0.16
LUSTRE_UNALIGNED_READ_EFF = 0.085

# mdtest calibration tables: ops/s (Tables I and II).
# Dom deployment: 2 metadata targets (1/node x 2 nodes).
EFS_MDTEST_DOM = {
    ("dir", "creation"): 8276.43,
    ("dir", "stat"): 5_301_788.76,   # client-cache-served (paper's explanation)
    ("dir", "removal"): 12967.02,
    ("file", "creation"): 6618.37,
    ("file", "stat"): 144410.46,
    ("file", "read"): 22541.08,
    ("file", "removal"): 8431.71,
    ("tree", "creation"): 2183.40,
    ("tree", "removal"): 125.23,
}
EFS_MDTEST_DOM_MD_TARGETS = 2
EFS_MDTEST_AULT = {
    ("dir", "creation"): 1796.31,
    ("dir", "stat"): 667250.43,
    ("dir", "removal"): 5516.92,
    ("file", "creation"): 5234.87,
    ("file", "stat"): 98888.28,
    ("file", "read"): 22889.51,
    ("file", "removal"): 5929.99,
    ("tree", "creation"): 2754.81,
    ("tree", "removal"): 980.84,
}
LUSTRE_MDTEST_DOM = {
    ("dir", "creation"): 37222.57,
    ("dir", "stat"): 182330.42,
    ("dir", "removal"): 38732.00,
    ("file", "creation"): 22916.15,
    ("file", "stat"): 169140.32,
    ("file", "read"): 45181.55,
    ("file", "removal"): 35985.96,
    ("tree", "creation"): 3310.42,
    ("tree", "removal"): 1298.55,
}
# Ops whose rate scales with metadata-target count (create/remove hit md
# disks; stats are cache-served and do not scale).
_MD_SCALING_OPS = {"creation", "removal", "read"}

# Deployment-time model (C8), solved from:  Ault fresh 4.6 s / warm 1.2 s over
# 8 targets (local docker), Dom 5.37 s over 3 targets/node (Shifter image over
# Aries dominates the base term).
DEPLOY_BASE_S = {"shifter": 3.945, "docker": 0.8}
DEPLOY_PER_TARGET_FRESH_S = 0.475
DEPLOY_PER_TARGET_WARM_S = 0.05


@dataclasses.dataclass(frozen=True)
class FSDeployment:
    """What the perfmodel needs to know about a deployed file system."""

    kind: Literal["ephemeral", "lustre"]
    n_nodes: int                      # storage nodes (or OSS hosts)
    storage_targets: int              # storage disks (or OSTs), total
    md_targets: int
    disk: DiskSpec
    node_dram: float = 64 * GiB
    net: InterconnectSpec = ARIES
    local_client: bool = False        # Ault: client co-located with storage
    mdtest_table: Optional[dict] = None

    @property
    def raw_write_bw(self) -> float:
        if self.kind == "lustre":
            return self.storage_targets * LUSTRE_OST_WRITE_BW
        return self.storage_targets * self.disk.write_bw

    @property
    def raw_read_bw(self) -> float:
        if self.kind == "lustre":
            return self.storage_targets * LUSTRE_OST_READ_BW
        return self.storage_targets * self.disk.read_bw

    @property
    def net_bw(self) -> float:
        """Aggregate server-side injection bandwidth toward clients."""
        if self.local_client:
            return self.n_nodes * LOCAL_PCIE.node_bw
        return self.n_nodes * self.net.node_bw


def dom_efs(n_nodes: int = 2) -> FSDeployment:
    """Paper default: BeeGFS over ``n_nodes`` DataWarp nodes, 1 md : 2 storage."""
    return FSDeployment(
        kind="ephemeral",
        n_nodes=n_nodes,
        storage_targets=2 * n_nodes,
        md_targets=n_nodes,
        disk=PM1725A_STREAMS,
        node_dram=64 * GiB,
        net=ARIES,
        mdtest_table=EFS_MDTEST_DOM,
    )


def dom_lustre() -> FSDeployment:
    return FSDeployment(
        kind="lustre",
        n_nodes=2,
        storage_targets=2,   # 2 OSTs
        md_targets=1,
        disk=PM1725A_STREAMS,  # unused for lustre bw
        net=ARIES,
        mdtest_table=LUSTRE_MDTEST_DOM,
    )


def ault_efs() -> FSDeployment:
    """Paper §IV-B: 1 mgmt disk, 2 metadata disks, 5 storage disks, local client."""
    return FSDeployment(
        kind="ephemeral",
        n_nodes=1,
        storage_targets=5,
        md_targets=2,
        disk=P4500_STREAMS,
        node_dram=376 * GiB,
        net=LOCAL_PCIE,
        local_client=True,
        mdtest_table=EFS_MDTEST_AULT,
    )


@dataclasses.dataclass(frozen=True)
class Workload:
    n_procs: int
    size_per_proc: float              # bytes per process (written and read back)
    pattern: Pattern = "shared"
    aligned: bool = True              # False: HACC-style 38-byte AoS records
    transfer_size: float = 1 * MiB

    @property
    def total_bytes(self) -> float:
        return self.n_procs * self.size_per_proc


@dataclasses.dataclass(frozen=True)
class BWResult:
    bandwidth: float                  # B/s as IOR reports (total/elapsed)
    peak_bandwidth: float             # steady-state (no setup overhead)
    elapsed_s: float
    cache_resident: bool              # read path served from server DRAM?
    bound: str                        # "disk" | "network" | "setup" | "cache-thrash"


def _interp_eff(table: dict[int, float], key: int) -> float:
    """Log-interpolate a {count: efficiency} calibration table."""
    if key in table:
        return table[key]
    ks = sorted(table)
    if key <= ks[0]:
        return table[ks[0]]
    if key >= ks[-1]:
        # Fig. 4: logarithmic growth of absolute bw => efficiency decays ~1/k
        # beyond the calibrated range, floored at 0.25.
        base = table[ks[-1]]
        return max(0.25, base * ks[-1] / key)
    lo = max(k for k in ks if k < key)
    hi = min(k for k in ks if k > key)
    t = (math.log(key) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return table[lo] * (1 - t) + table[hi] * t


def predict_write(w: Workload, d: FSDeployment) -> BWResult:
    if d.kind == "lustre":
        eff = 1.0 if w.aligned else LUSTRE_UNALIGNED_WRITE_EFF
        peak = min(d.raw_write_bw * eff, d.net_bw)
        setup = LUSTRE_SETUP_S
    else:
        if w.pattern == "fpp":
            eff = EFS_FPP_WRITE_EFF
            setup = EFS_FPP_SETUP_S + w.n_procs / _md_rate(d, "file", "creation")
        else:
            eff = _interp_eff(EFS_SHARED_WRITE_EFF, d.storage_targets)
            if not w.aligned:
                eff *= EFS_UNALIGNED_WRITE_FACTOR
            setup = EFS_SHARED_SETUP_S
        peak = min(d.raw_write_bw * eff, d.net_bw)
    elapsed = w.total_bytes / peak + setup
    bw = w.total_bytes / elapsed
    bound = "setup" if setup > 0.5 * elapsed else (
        "network" if peak == d.net_bw else "disk"
    )
    return BWResult(bw, peak, elapsed, cache_resident=False, bound=bound)


def _efs_cache_resident(w: Workload, d: FSDeployment) -> bool:
    per_node = w.total_bytes / d.n_nodes
    return per_node <= EFS_CACHE_USABLE_FRAC * d.node_dram


def predict_read(w: Workload, d: FSDeployment) -> BWResult:
    """Read-back of data just written (IOR's default write-then-read)."""
    if d.kind == "lustre":
        eff = 1.0 if w.aligned else LUSTRE_UNALIGNED_READ_EFF
        peak = min(d.raw_read_bw * eff, d.net_bw)
        elapsed = w.total_bytes / peak + LUSTRE_READ_SETUP_S
        return BWResult(w.total_bytes / elapsed, peak, elapsed, False, "disk")

    resident = _efs_cache_resident(w, d)
    if resident:
        eff = EFS_SHARED_READ_EFF if w.pattern == "shared" else EFS_FPP_READ_EFF
        peak = eff * d.net_bw
        if d.local_client:
            # no network hop; bounded by disk+page-cache reads
            peak = min(d.raw_read_bw * (EFS_FPP_READ_EFF + 0.4), d.net_bw)
            peak = min(peak, d.raw_read_bw * 0.95) if w.pattern == "fpp" else min(
                peak, d.raw_read_bw * 0.75
            )
        bound = "network"
    else:
        # C2: LRU sequential read-back of an over-cache working set -> ~0 hits.
        peak = EFS_THRASH_READ_EFF * d.raw_read_bw
        bound = "cache-thrash"
    elapsed = w.total_bytes / peak + EFS_READ_SETUP_S
    return BWResult(w.total_bytes / elapsed, peak, elapsed, resident, bound)


def predict(w: Workload, d: FSDeployment, op: Op) -> BWResult:
    return predict_write(w, d) if op == "write" else predict_read(w, d)


# --------------------------------------------------------------------------
# Metadata (mdtest)
# --------------------------------------------------------------------------
def _md_rate(d: FSDeployment, target: str, op: str) -> float:
    table = d.mdtest_table
    if table is None:
        table = EFS_MDTEST_DOM if d.kind == "ephemeral" else LUSTRE_MDTEST_DOM
    rate = table[(target, op)]
    if d.kind == "ephemeral" and op in _MD_SCALING_OPS:
        base = EFS_MDTEST_DOM_MD_TARGETS if table is EFS_MDTEST_DOM else d.md_targets
        rate = rate * d.md_targets / base
    return rate


def predict_mdtest(d: FSDeployment) -> dict[tuple[str, str], float]:
    table = d.mdtest_table or (EFS_MDTEST_DOM if d.kind == "ephemeral" else LUSTRE_MDTEST_DOM)
    return {key: _md_rate(d, *key) for key in table}


# --------------------------------------------------------------------------
# Deployment time (C8)
# --------------------------------------------------------------------------
def predict_deploy_time(
    targets_per_node: int,
    *,
    runtime: Literal["shifter", "docker"] = "shifter",
    fresh: bool = True,
) -> float:
    """Services on each node start in parallel; per-node work is serial in its
    targets (format/daemon-start per disk)."""
    per_target = DEPLOY_PER_TARGET_FRESH_S if fresh else DEPLOY_PER_TARGET_WARM_S
    return DEPLOY_BASE_S[runtime] + targets_per_node * per_target


# --------------------------------------------------------------------------
# HACC-IO helpers (§IV-A4)
# --------------------------------------------------------------------------
HACC_PARTICLE_BYTES = 38      # XX,YY,ZZ,VX,VY,VZ,phi (7xf32) + pid (i64) + mask (u16)
HACC_VARS = 9


def hacc_workload(n_procs: int, particles_per_proc: int) -> Workload:
    return Workload(
        n_procs=n_procs,
        size_per_proc=particles_per_proc * HACC_PARTICLE_BYTES,
        pattern="shared",
        aligned=False,
        transfer_size=HACC_PARTICLE_BYTES,
    )


# --------------------------------------------------------------------------
# TPU hardware profile for the roofline analysis (brief-specified constants)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPUProfile:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12     # per chip
    hbm_bw: float = 819e9               # B/s per chip
    ici_link_bw: float = 50e9           # B/s per link
    hbm_bytes: float = 16 * GiB


TPU_V5E = TPUProfile()


# --------------------------------------------------------------------------
# GPU hardware profile: one NVIDIA H100 SXM (the port's card)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GPUProfile:
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12     # dense, tensor cores (NVIDIA data sheet, SXM)
    peak_flops_tf32: float = 495e12     # dense, tensor cores
    peak_flops_fp32: float = 67e12      # outside the tensor cores
    hbm_bw: float = 3.35e12             # B/s, HBM3
    # NVLink 4: 18 links x 25 GB/s = 450 GB/s in each direction (the 900 GB/s
    # usually quoted sums both). A GPU's collective result bytes cross its
    # links in one direction, so collective_s divides them by this rate, as
    # the TPU profile's ici_link_bw is used.
    nvlink_bw: float = 450e9
    n_sms: int = 132
    # torch.cuda.get_device_properties(0).total_memory of an
    # "NVIDIA H100 80GB HBM3"
    hbm_bytes: float = 85_017_493_504


H100 = GPUProfile()
