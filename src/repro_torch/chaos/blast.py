"""Blast-radius resolver: what a dead storage node actually takes out.

One node id fans out along three edges, all resolved duck-typed so this
module imports nothing from the subsystems it inspects:

* **sessions** — live :class:`StorageSession` objects whose dedicated
  allocation (or whose PERSISTENT pool) includes the node. These are the
  deployments that degrade (mirror redundancy) or die (none).
* **pools** — :class:`StoragePool` objects whose allocation pins the
  node, plus every lease currently attached to them: striping puts every
  dataset on every node, so a pool node loss invalidates the pool's
  residency wholesale and its leaseholders with it.
* **replicas** — serving replicas whose lease points into an affected
  pool (or whose own session touches the node): their in-flight requests
  must abort back to the queue.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


def _session_touches(session, node_id: str) -> bool:
    alloc = getattr(session, "allocation", None)
    if alloc is not None and any(
        n.node_id == node_id for n in alloc.storage_nodes
    ):
        return True
    pool = getattr(session, "pool", None)
    return pool is not None and node_id in pool.storage_node_ids


@dataclasses.dataclass(frozen=True)
class BlastRadius:
    """Everything touching one dead node, resolved at the failure instant."""

    node_id: str
    sessions: tuple                  # live StorageSessions on the node
    pools: tuple                     # StoragePools pinning the node
    leases: tuple                    # leases attached to those pools
    replicas: tuple                  # serving replicas in the fan-out

    @property
    def empty(self) -> bool:
        return not (self.sessions or self.pools or self.replicas)


def resolve_blast_radius(
    node_id: str,
    *,
    sessions: Iterable = (),
    pools: Iterable = (),
    replicas: Iterable = (),
) -> BlastRadius:
    """Resolve the fan-out of ``node_id`` over live objects.

    ``sessions``/``pools``/``replicas`` are whatever the caller has live:
    the orchestrator passes its active jobs' sessions and the pool
    manager's live pools; a serving campaign passes its replica fleet.
    """
    hit_pools = tuple(p for p in pools if node_id in p.storage_node_ids)
    pool_ids = {p.pool_id for p in hit_pools}
    hit_sessions = []
    for s in sessions:
        if _session_touches(s, node_id):
            hit_sessions.append(s)
        else:
            lease = getattr(s, "lease", None)
            if lease is not None and lease.pool_id in pool_ids:
                hit_sessions.append(s)
    hit_replicas = []
    for r in replicas:
        s = getattr(r, "session", None)
        if s is None:
            continue
        lease = getattr(s, "lease", None)
        if (lease is not None and lease.pool_id in pool_ids) or _session_touches(
            s, node_id
        ):
            hit_replicas.append(r)
    leases = tuple(
        lease for p in hit_pools for lease in p.leases.values()
    )
    return BlastRadius(
        node_id=node_id,
        sessions=tuple(hit_sessions),
        pools=hit_pools,
        leases=leases,
        replicas=tuple(hit_replicas),
    )
