"""GlobalFS: the Lustre-analogue shared parallel file system (the baseline).

On Dom the global store is Lustre with 2 OSTs and a dedicated MDS (§IV-A).
Functionally we reuse the striped-FS machinery (MDS = 1 metadata service,
OSTs = storage services, stripe_count configurable like ``lfs setstripe -c``);
the analytic view is ``perfmodel.dom_lustre()``. Unlike EphemeralFS it is
*not* job-scoped: it pre-exists jobs and survives them.
"""

from __future__ import annotations

import tempfile

from .datamanager import ServiceInfo
from .ephemeralfs import EphemeralFS
from .perfmodel import FSDeployment, dom_lustre
from .resources import GiB, TB, Disk, DiskSpec, StorageNode
from .striping import DEFAULT_STRIPE

# An OST on Dom: 170 TB usable over 2 OSTs.
LUSTRE_OST = DiskSpec("lustre-ost", 85 * TB, read_bw=2.3e9, write_bw=3.0e9, iops_4k=50e3)
LUSTRE_MDT = DiskSpec("lustre-mdt", 2 * TB, read_bw=2.0e9, write_bw=2.0e9, iops_4k=500e3)


class GlobalFS(EphemeralFS):
    """Shared parallel FS with ``stripe_count`` OSTs (paper sets -c 2)."""

    def __init__(
        self,
        base_dir: str | None = None,
        *,
        n_osts: int = 2,
        stripe_size: int = DEFAULT_STRIPE,
    ):
        base_dir = base_dir or tempfile.mkdtemp(prefix="lustre-")
        mds = StorageNode(
            "lustre-mds0",
            disks=(Disk("lustre-mds0", 0, LUSTRE_MDT),) + tuple(
                Disk("lustre-mds0", 1 + i, LUSTRE_OST) for i in range(n_osts)
            ),
            dram_bytes=256 * GiB,
        )
        super().__init__(
            (mds,),
            base_dir,
            md_disks_per_node=1,
            storage_disks_per_node=n_osts,
            stripe_size=stripe_size,
        )
        self.n_osts = n_osts

    def services(self) -> list[ServiceInfo]:
        infos = super().services()
        for info in infos:
            if info.kind == "metadata":
                info.kind = "mds"
            elif info.kind == "storage":
                info.kind = "ost"
        return infos

    def perf_view(self) -> FSDeployment:
        return dom_lustre()
