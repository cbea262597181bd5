"""EphemeralKV: a second data-manager type on the same provisioning substrate.

The paper's concluding pitch (§VII) is that the mechanism is *generic*:
"a unique container packaging various data management systems ... (parallel
file system, object-based storage, database, key-value store)". This module
proves the abstraction: a hash-partitioned KV store deployed on the same
storage allocations, with the same lifecycle (deploy → use → teardown
deletes everything), the same service model, and the same failure semantics
(optional next-node replica).

Used by the serving stack as a feature/embedding cache tier.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import struct
from typing import Iterator, Optional

from .datamanager import FSError, ServiceInfo
from .resources import StorageNode

_LEN = struct.Struct("<q")


class KVShard:
    """One partition, backed by one storage disk (append-log + index)."""

    def __init__(self, shard_id: int, node_id: str, disk_name: str, path: str):
        self.shard_id = shard_id
        self.node_id = node_id
        self.disk_name = disk_name
        self.path = path
        self.alive = True
        self.index: dict[bytes, tuple[int, int]] = {}
        self.ops = {"put": 0, "get": 0, "delete": 0}
        os.makedirs(path, exist_ok=True)
        self._log = open(os.path.join(path, "log.bin"), "ab+")

    def _check(self) -> None:
        if not self.alive:
            raise FSError(f"kv shard {self.shard_id} is down")

    def put(self, key: bytes, value: bytes) -> None:
        self._check()
        self.ops["put"] += 1
        self._log.seek(0, 2)
        off = self._log.tell()
        self._log.write(_LEN.pack(len(value)))
        self._log.write(value)
        self._log.flush()
        self.index[key] = (off + _LEN.size, len(value))

    def get(self, key: bytes) -> Optional[bytes]:
        self._check()
        self.ops["get"] += 1
        loc = self.index.get(key)
        if loc is None:
            return None
        off, ln = loc
        self._log.seek(off)
        return self._log.read(ln)

    def delete(self, key: bytes) -> bool:
        self._check()
        self.ops["delete"] += 1
        return self.index.pop(key, None) is not None

    def keys(self) -> Iterator[bytes]:
        self._check()
        return iter(list(self.index))

    def close(self) -> None:
        self.alive = False
        self.index.clear()
        try:
            self._log.close()
        except Exception:  # noqa: BLE001
            pass


class EphemeralKV:
    """Job-scoped KV store over the granted storage nodes.

    Layout: every non-metadata disk hosts one shard; keys are partitioned by
    blake2s hash. ``replicate=True`` mirrors each key to the next shard on a
    different node (same failure-domain rule as EphemeralFS mirroring).
    """

    def __init__(
        self,
        storage_nodes: tuple[StorageNode, ...],
        base_dir: str,
        *,
        shards_per_node: int = 2,
        replicate: bool = False,
    ):
        if not storage_nodes:
            raise FSError("need at least one storage node")
        self.base_dir = base_dir
        self.replicate = replicate
        self._torn_down = False
        self.shards: list[KVShard] = []
        for node in storage_nodes:
            if node.n_disks < shards_per_node:
                raise FSError(f"{node.node_id}: fewer disks than shards/node")
            for d in range(shards_per_node):
                self.shards.append(
                    KVShard(
                        len(self.shards),
                        node.node_id,
                        node.disks[d].name,
                        os.path.join(base_dir, node.node_id, f"kv{d}"),
                    )
                )
        if replicate and len({s.node_id for s in self.shards}) < 2:
            raise FSError("replication needs shards on >= 2 nodes")

    # -- partitioning ---------------------------------------------------------
    def _shard_of(self, key: bytes) -> int:
        h = hashlib.blake2s(key).digest()
        return int.from_bytes(h[:4], "little") % len(self.shards)

    def _replica_of(self, shard: int) -> int:
        nid = self.shards[shard].node_id
        n = len(self.shards)
        for step in range(1, n):
            cand = (shard + step) % n
            if self.shards[cand].node_id != nid:
                return cand
        return (shard + 1) % n

    def _check(self) -> None:
        if self._torn_down:
            raise FSError("kv store has been torn down")

    # -- API -----------------------------------------------------------------
    def put(self, key: str | bytes, value: bytes) -> None:
        self._check()
        k = key.encode() if isinstance(key, str) else key
        sid = self._shard_of(k)
        primary = self.shards[sid]
        wrote = False
        if primary.alive:
            primary.put(k, value)
            wrote = True
        elif not self.replicate:
            raise FSError(f"shard {sid} down (no replica)")
        if self.replicate:
            rep = self.shards[self._replica_of(sid)]
            if rep.alive:
                rep.put(k, value)
            elif not wrote:
                raise FSError(f"both replicas of shard {sid} down")

    def get(self, key: str | bytes) -> Optional[bytes]:
        self._check()
        k = key.encode() if isinstance(key, str) else key
        sid = self._shard_of(k)
        primary = self.shards[sid]
        if primary.alive:
            return primary.get(k)
        if self.replicate:
            rep = self.shards[self._replica_of(sid)]
            if rep.alive:
                return rep.get(k)
        raise FSError(f"shard {sid} down")

    def delete(self, key: str | bytes) -> bool:
        self._check()
        k = key.encode() if isinstance(key, str) else key
        sid = self._shard_of(k)
        hit = False
        targets = [sid] + ([self._replica_of(sid)] if self.replicate else [])
        for t in targets:
            if self.shards[t].alive:
                hit = self.shards[t].delete(k) or hit
        return hit

    def scan(self) -> set[bytes]:
        self._check()
        out: set[bytes] = set()
        for s in self.shards:
            if s.alive:
                out.update(s.keys())
        return out

    # -- lifecycle -------------------------------------------------------------
    def services(self) -> list[ServiceInfo]:
        return [
            ServiceInfo("kv-shard", s.node_id, s.disk_name, alive=s.alive)
            for s in self.shards
        ]

    def kill_node(self, node_id: str) -> None:
        found = False
        for s in self.shards:
            if s.node_id == node_id:
                s.alive = False
                found = True
        if not found:
            raise FSError(f"no kv shards on {node_id}")

    def healthy(self) -> bool:
        return not self._torn_down and all(s.alive for s in self.shards)

    def teardown(self) -> None:
        self._torn_down = True
        for s in self.shards:
            s.close()
        shutil.rmtree(self.base_dir, ignore_errors=True)
