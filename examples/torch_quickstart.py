"""Quickstart: the paper's core flow in one page, through the storage API.

Declare what the job needs (`StorageSpec`), let the `ProvisioningService`
negotiate a data manager and grant compute + storage in one scheduler pass
(the paper's key move — storage is requested like any constraint-tagged
node), mount the provisioned FS from a compute node, do I/O, inspect the
deployment, release everything by leaving the session.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.core import Workload, dom_cluster, predict_write
from repro_torch.provision import ProvisioningService, StorageSpec

# 1. a cluster with 8 compute nodes + 4 DataWarp-style storage nodes
service = ProvisioningService(dom_cluster())

# 2. one declarative request: 8 compute nodes co-allocated with 20 TB of
#    burst storage (-> 2 DataWarp nodes), preferred data manager first,
#    fallbacks in order — capacity sizing keeps the shared-FS fallback real
spec = StorageSpec("quickstart", capacity_bytes=20e12,
                   managers=("ephemeralfs", "globalfs"))

with service.open_session(spec, n_compute=8, materialize=True) as session:
    alloc = session.allocation
    print(f"negotiated {session.backend}: {len(alloc.compute_nodes)} compute, "
          f"{[n.node_id for n in session.storage_nodes]} storage")

    # 3. the ephemeral parallel FS is provisioned (1 md : 2 storage disks/node)
    dep = session.deployment
    print(f"deployed {len(dep.fs.services())} services in "
          f"{session.provision_time_s:.2f}s (modeled, C8)")
    for svc in dep.fs.services():
        print(f"  {svc.kind:12s} on {svc.node_id} ({svc.disk_name})")

    # 4. mount from a compute node and do real I/O
    client = session.mount("nid00001")
    client.mkdir("/results")
    client.create("/results/out.bin")
    client.pwrite("/results/out.bin", 0, b"hello burst tier" * 65536)  # 1 MiB
    data = client.pread("/results/out.bin", 0, 16)
    print(f"read back: {data!r}; file striped over "
          f"{client.stat('/results/out.bin').n_targets} targets")

    # 5. what would this deployment sustain at paper scale?
    w = Workload(n_procs=288, size_per_proc=64 << 20, pattern="fpp")
    print(f"modeled file-per-process write: "
          f"{predict_write(w, session.fs_model).peak_bandwidth / 1e9:.2f} GB/s")

# 6. session exit: services killed, data deleted, nodes returned
print("released:", service.scheduler.free_counts())
