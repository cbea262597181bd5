"""EphemeralFS: the BeeGFS-analogue deployed on demand over storage nodes.

Functionally faithful to the paper's BeeGFS deployment (§III-C):

* four service roles -- **management** (orchestration/registry), **metadata**
  (namespace, striping info; one per metadata disk, namespace spread by
  parent-directory hash, like BeeGFS dirent distribution), **storage** (one
  per storage disk, owns raw chunks), **monitor** (counter aggregation);
* round-robin 1 MiB striping across all storage targets;
* job-scoped: ``teardown()`` kills services and deletes every byte
  (the paper: "services on storage nodes are killed and data on disks is
  deleted");
* optional chunk mirroring (beyond-paper: survives a storage-node loss).

This layer moves *real bytes* (chunk files under a backing directory per
disk) so correctness is testable end-to-end; timing at paper scale is the
job of ``perfmodel``. A per-node ``CacheSim`` reproduces the server-side
DRAM cache *mechanism* behind the paper's read-collapse observation (C2).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
from collections import OrderedDict
from typing import Optional

from .datamanager import (
    DataManager,
    FSError,
    FileStat,
    ServiceInfo,
    normpath,
    parent_of,
)
from .resources import Disk, StorageNode
from .striping import DEFAULT_STRIPE, StripeConfig, extents_for_range


class CacheSim:
    """Per-node server-side DRAM cache (LRU over chunk keys).

    Models the mechanism behind the paper's Fig. 2 read collapse: once the
    per-node working set exceeds node DRAM (64 GB on Dom), reads fall off the
    cache to disk. Tracks hits/misses/evictions; capacity is bytes.
    """

    def __init__(self, capacity_bytes: float):
        self.capacity = float(capacity_bytes)
        self._lru: OrderedDict[str, int] = OrderedDict()
        self.resident = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def touch(self, key: str, nbytes: int, *, is_read: bool) -> bool:
        """Record an access; returns True on hit (for reads)."""
        hit = key in self._lru
        if hit:
            self._lru.move_to_end(key)
            if is_read:
                self.hits += 1
        else:
            if is_read:
                self.misses += 1
            self._lru[key] = nbytes
            self.resident += nbytes
            while self.resident > self.capacity and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self.resident -= evicted
                self.evictions += 1
        return hit

    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


@dataclasses.dataclass
class Inode:
    path: str
    is_dir: bool
    size: int = 0
    file_id: int = 0
    stripe: Optional[StripeConfig] = None
    xattrs: dict = dataclasses.field(default_factory=dict)


class MetadataService:
    """Owns a shard of the namespace. BeeGFS spreads directory entries over
    metadata servers; we shard by parent-directory hash."""

    def __init__(self, service_id: int, node_id: str, disk: Disk):
        self.service_id = service_id
        self.node_id = node_id
        self.disk = disk
        self.alive = True
        self.inodes: dict[str, Inode] = {}
        self.children: dict[str, set[str]] = {}
        self.ops: dict[str, int] = {}

    def _count(self, op: str) -> None:
        self.ops[op] = self.ops.get(op, 0) + 1

    def _check(self) -> None:
        if not self.alive:
            raise FSError(f"metadata service {self.service_id} is down")

    def insert(self, inode: Inode) -> None:
        self._check()
        self._count("create")
        if inode.path in self.inodes:
            raise FSError(f"exists: {inode.path}")
        self.inodes[inode.path] = inode
        self.children.setdefault(inode.path, set()) if inode.is_dir else None

    def register_child(self, parent: str, name: str) -> None:
        self._check()
        self.children.setdefault(parent, set()).add(name)

    def drop_child(self, parent: str, name: str) -> None:
        self._check()
        self.children.get(parent, set()).discard(name)

    def lookup(self, path: str) -> Inode:
        self._check()
        self._count("stat")
        ino = self.inodes.get(path)
        if ino is None:
            raise FSError(f"no such file: {path}")
        return ino

    def remove(self, path: str) -> Inode:
        self._check()
        self._count("remove")
        ino = self.inodes.pop(path, None)
        if ino is None:
            raise FSError(f"no such file: {path}")
        self.children.pop(path, None)
        return ino

    def listdir(self, path: str) -> list[str]:
        self._check()
        self._count("readdir")
        return sorted(self.children.get(path, set()))


class StorageService:
    """Owns one storage target (= one disk). Chunks are real files under
    ``target_dir``; a shared per-node CacheSim accounts DRAM residency."""

    def __init__(
        self,
        service_id: int,
        node_id: str,
        disk: Disk,
        target_dir: str,
        cache: CacheSim,
    ):
        self.service_id = service_id
        self.node_id = node_id
        self.disk = disk
        self.target_dir = target_dir
        self.cache = cache
        self.alive = True
        self.bytes_written = 0
        self.bytes_read = 0
        self.chunks = 0
        os.makedirs(target_dir, exist_ok=True)

    def _chunk_path(self, file_id: int, chunk_id: int) -> str:
        return os.path.join(self.target_dir, f"{file_id:08x}.{chunk_id:08d}")

    def _check(self) -> None:
        if not self.alive:
            raise FSError(f"storage service {self.service_id} is down")

    def write_chunk(self, file_id: int, chunk_id: int, offset: int, data: bytes) -> None:
        self._check()
        p = self._chunk_path(file_id, chunk_id)
        new = not os.path.exists(p)
        mode = "r+b" if not new else "wb"
        with open(p, mode) as f:
            f.seek(offset)
            f.write(data)
        if new:
            self.chunks += 1
        self.bytes_written += len(data)
        self.cache.touch(f"{self.service_id}:{file_id}:{chunk_id}", len(data), is_read=False)

    def read_chunk(self, file_id: int, chunk_id: int, offset: int, length: int) -> bytes:
        self._check()
        self.cache.touch(f"{self.service_id}:{file_id}:{chunk_id}", length, is_read=True)
        p = self._chunk_path(file_id, chunk_id)
        if not os.path.exists(p):
            return b"\x00" * length            # sparse region
        with open(p, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        self.bytes_read += len(buf)
        if len(buf) < length:                   # short chunk file -> zero fill
            buf += b"\x00" * (length - len(buf))
        return buf

    def drop_file(self, file_id: int) -> None:
        if not self.alive:
            return
        prefix = f"{file_id:08x}."
        for name in os.listdir(self.target_dir):
            if name.startswith(prefix):
                os.unlink(os.path.join(self.target_dir, name))
                self.chunks -= 1


class ManagementService:
    """BeeGFS management daemon analogue: service registry + heartbeats."""

    def __init__(self, node_id: str, disk: Disk):
        self.node_id = node_id
        self.disk = disk
        self.alive = True
        self.registry: list[ServiceInfo] = []

    def register(self, info: ServiceInfo) -> None:
        self.registry.append(info)


class MonitorService:
    def __init__(self, node_id: str, disk: Disk):
        self.node_id = node_id
        self.disk = disk
        self.alive = True

    def collect(self, fs: "EphemeralFS") -> dict:
        return {
            "md_ops": {s.service_id: dict(s.ops) for s in fs.md_services},
            "storage": {
                s.service_id: {
                    "bytes_written": s.bytes_written,
                    "bytes_read": s.bytes_read,
                    "chunks": s.chunks,
                }
                for s in fs.storage_services
            },
            "cache": {
                nid: {
                    "resident": c.resident,
                    "hit_rate": c.hit_rate(),
                    "evictions": c.evictions,
                }
                for nid, c in fs.caches.items()
            },
        }


def _md_shard(path: str, n: int) -> int:
    parent = parent_of(path)
    return int.from_bytes(hashlib.blake2s(parent.encode()).digest()[:4], "little") % n


class EphemeralFS(DataManager):
    """The dynamically-provisioned, job-scoped parallel FS (paper §III)."""

    def __init__(
        self,
        storage_nodes: tuple[StorageNode, ...],
        base_dir: str,
        *,
        md_disks_per_node: int = 1,
        storage_disks_per_node: int = 2,
        stripe_size: int = DEFAULT_STRIPE,
        mirror: bool = False,
        cache_capacity_override: Optional[float] = None,
    ):
        if not storage_nodes:
            raise FSError("need at least one storage node")
        self.storage_nodes = storage_nodes
        self.base_dir = base_dir
        self.stripe_size = stripe_size
        self.mirror = mirror
        self.md_disks_per_node = md_disks_per_node
        self.storage_disks_per_node = storage_disks_per_node
        self._torn_down = False
        self._next_file_id = 1
        self._degraded_targets: set[int] = set()

        self.caches: dict[str, CacheSim] = {}
        self.md_services: list[MetadataService] = []
        self.storage_services: list[StorageService] = []

        # Paper layout (§IV-A): per node, disk 0 -> metadata; next
        # ``storage_disks_per_node`` disks -> storage. mgmt + monitor share
        # the first node's metadata disk.
        for ni, node in enumerate(storage_nodes):
            need = md_disks_per_node + storage_disks_per_node
            if node.n_disks < need:
                raise FSError(
                    f"{node.node_id}: {node.n_disks} disks < {need} required by layout"
                )
            cap = cache_capacity_override if cache_capacity_override is not None else node.dram_bytes
            self.caches[node.node_id] = CacheSim(cap)
            for d in range(md_disks_per_node):
                disk = node.disks[d]
                self.md_services.append(MetadataService(len(self.md_services), node.node_id, disk))
            for d in range(md_disks_per_node, need):
                disk = node.disks[d]
                tdir = os.path.join(base_dir, node.node_id, f"nvme{d}")
                self.storage_services.append(
                    StorageService(
                        len(self.storage_services),
                        node.node_id,
                        disk,
                        tdir,
                        self.caches[node.node_id],
                    )
                )

        first = storage_nodes[0]
        self.mgmt = ManagementService(first.node_id, first.disks[0])
        self.monitor = MonitorService(first.node_id, first.disks[0])
        for s in self.md_services:
            self.mgmt.register(ServiceInfo("metadata", s.node_id, s.disk.name))
        for s in self.storage_services:
            self.mgmt.register(ServiceInfo("storage", s.node_id, s.disk.name))
        self.mgmt.register(ServiceInfo("management", self.mgmt.node_id, self.mgmt.disk.name))
        self.mgmt.register(ServiceInfo("monitor", self.monitor.node_id, self.monitor.disk.name))

        if mirror and len(self.storage_services) < 2:
            raise FSError("mirror mode needs >= 2 storage targets")

        # root directory lives on shard of "/" (replicated in mirror mode)
        root = Inode("/", is_dir=True)
        for svc in self._md_writers("/"):
            svc.insert(root)

    # -- routing ---------------------------------------------------------
    @property
    def n_targets(self) -> int:
        return len(self.storage_services)

    def _md_for(self, path: str) -> MetadataService:
        """Service to READ path metadata from. Mirror mode replicates the
        namespace (shared Inode objects) so any alive service works."""
        svc = self.md_services[_md_shard(path, len(self.md_services))]
        if not svc.alive and self.mirror:
            for s in self.md_services:
                if s.alive:
                    return s
        return svc

    def _md_writers(self, path: str) -> list[MetadataService]:
        """Services to apply a namespace MUTATION to."""
        if self.mirror:
            out = [s for s in self.md_services if s.alive]
            if not out:
                raise FSError("all metadata services are down")
            return out
        return [self.md_services[_md_shard(path, len(self.md_services))]]

    def _check_live(self) -> None:
        if self._torn_down:
            raise FSError("filesystem has been torn down")

    def _mirror_of(self, target: int) -> int:
        """Next target on a DIFFERENT node (chunk replicas must not share a
        failure domain); falls back to next target on single-node deploys."""
        n = self.n_targets
        nid = self.storage_services[target].node_id
        for step in range(1, n):
            cand = (target + step) % n
            if self.storage_services[cand].node_id != nid:
                return cand
        return (target + 1) % n

    # -- DataManager: lifecycle -------------------------------------------
    def services(self) -> list[ServiceInfo]:
        infos = list(self.mgmt.registry)
        for info in infos:
            if info.kind == "metadata":
                svc = next(s for s in self.md_services if s.disk.name == info.disk_name)
                info.alive = svc.alive
            elif info.kind == "storage":
                svc = next(s for s in self.storage_services if s.disk.name == info.disk_name)
                info.alive = svc.alive
        return infos

    def teardown(self, *, keep_data: bool = False) -> None:
        """Kill all services; delete every byte unless ``keep_data`` (the
        warm-redeploy scenario: services stop but the tree survives, so the
        next deploy over the same base_dir pays the §IV-B1 warm cost)."""
        self._torn_down = True
        for s in self.md_services:
            s.alive = False
            s.inodes.clear()
            s.children.clear()
        for s in self.storage_services:
            s.alive = False
        self.mgmt.alive = False
        self.monitor.alive = False
        if not keep_data:
            shutil.rmtree(self.base_dir, ignore_errors=True)

    # -- DataManager: namespace --------------------------------------------
    def _require_parent(self, path: str) -> None:
        parent = parent_of(path)
        ino = self._md_for(parent).inodes.get(parent)
        if ino is None or not ino.is_dir:
            raise FSError(f"parent directory missing: {parent}")

    def create(self, path: str) -> None:
        self._check_live()
        path = normpath(path)
        self._require_parent(path)
        fid = self._next_file_id
        self._next_file_id += 1
        stripe = StripeConfig(self.stripe_size, self.n_targets, shift=fid % self.n_targets)
        ino = Inode(path, is_dir=False, file_id=fid, stripe=stripe)
        for svc in self._md_writers(path):
            svc.insert(ino)             # shared object: replicas stay in sync
        for svc in self._md_writers(parent_of(path)):
            svc.register_child(parent_of(path), path.rsplit("/", 1)[1])

    def mkdir(self, path: str) -> None:
        self._check_live()
        path = normpath(path)
        self._require_parent(path)
        ino = Inode(path, is_dir=True)
        for svc in self._md_writers(path):
            svc.insert(ino)
        for svc in self._md_writers(parent_of(path)):
            svc.register_child(parent_of(path), path.rsplit("/", 1)[1])

    def stat(self, path: str) -> FileStat:
        self._check_live()
        path = normpath(path)
        ino = self._md_for(path).lookup(path)
        return FileStat(
            path=path,
            size=ino.size,
            is_dir=ino.is_dir,
            stripe_size=self.stripe_size,
            n_targets=self.n_targets,
        )

    def readdir(self, path: str) -> list[str]:
        self._check_live()
        path = normpath(path)
        ino = self._md_for(path).lookup(path)
        if not ino.is_dir:
            raise FSError(f"not a directory: {path}")
        return self._md_for(path).listdir(path)

    def unlink(self, path: str) -> None:
        self._check_live()
        path = normpath(path)
        ino = self._md_for(path).lookup(path)
        if ino.is_dir:
            raise FSError(f"is a directory: {path}")
        for svc in self._md_writers(path):
            svc.remove(path)
        for svc in self._md_writers(parent_of(path)):
            svc.drop_child(parent_of(path), path.rsplit("/", 1)[1])
        for s in self.storage_services:
            s.drop_file(ino.file_id)

    def rmdir(self, path: str) -> None:
        self._check_live()
        path = normpath(path)
        if path == "/":
            raise FSError("cannot remove root")
        ino = self._md_for(path).lookup(path)
        if not ino.is_dir:
            raise FSError(f"not a directory: {path}")
        if self._md_for(path).listdir(path):
            raise FSError(f"directory not empty: {path}")
        for svc in self._md_writers(path):
            svc.remove(path)
        for svc in self._md_writers(parent_of(path)):
            svc.drop_child(parent_of(path), path.rsplit("/", 1)[1])

    # -- DataManager: data ----------------------------------------------------
    def write(self, path: str, offset: int, data: bytes) -> int:
        self._check_live()
        path = normpath(path)
        md = self._md_for(path)
        ino = md.lookup(path)
        if ino.is_dir:
            raise FSError(f"is a directory: {path}")
        assert ino.stripe is not None
        view = memoryview(data)
        pos = 0
        for ext in extents_for_range(ino.stripe, offset, len(data)):
            piece = view[pos : pos + ext.length]
            self._write_extent(ino.file_id, ext.target, ext.chunk_id, ext.chunk_offset, piece)
            pos += ext.length
        ino.size = max(ino.size, offset + len(data))
        return len(data)

    def _write_extent(self, fid: int, target: int, chunk: int, off: int, piece) -> None:
        primary = self.storage_services[target]
        wrote_primary = False
        if primary.alive:
            primary.write_chunk(fid, chunk, off, bytes(piece))
            wrote_primary = True
        elif not self.mirror:
            raise FSError(f"storage target {target} is down (no mirror)")
        else:
            self._degraded_targets.add(target)
        if self.mirror:
            m = self.storage_services[self._mirror_of(target)]
            if m.alive:
                m.write_chunk(fid, chunk + (1 << 40), off, bytes(piece))
            elif not wrote_primary:
                raise FSError(f"both replicas of target {target} are down")

    def read(self, path: str, offset: int, length: int) -> bytes:
        self._check_live()
        path = normpath(path)
        ino = self._md_for(path).lookup(path)
        if ino.is_dir:
            raise FSError(f"is a directory: {path}")
        assert ino.stripe is not None
        out = bytearray()
        for ext in extents_for_range(ino.stripe, offset, length):
            primary = self.storage_services[ext.target]
            if primary.alive:
                out += primary.read_chunk(ino.file_id, ext.chunk_id, ext.chunk_offset, ext.length)
            elif self.mirror:
                m = self.storage_services[self._mirror_of(ext.target)]
                if not m.alive:
                    raise FSError(f"both replicas of target {ext.target} are down")
                out += m.read_chunk(ino.file_id, ext.chunk_id + (1 << 40), ext.chunk_offset, ext.length)
            else:
                raise FSError(f"storage target {ext.target} is down (no mirror)")
        return bytes(out)

    # -- failure injection ------------------------------------------------
    def kill_node(self, node_id: str) -> None:
        found = False
        for s in self.storage_services:
            if s.node_id == node_id:
                s.alive = False
                found = True
        for s in self.md_services:
            if s.node_id == node_id:
                s.alive = False
                found = True
        if not found:
            raise FSError(f"no services on node {node_id}")

    def healthy(self) -> bool:
        services_ok = all(s.alive for s in self.storage_services + self.md_services)
        return services_ok and not self._degraded_targets and not self._torn_down

    def degraded(self) -> bool:
        return bool(self._degraded_targets) or not all(
            s.alive for s in self.storage_services
        )
