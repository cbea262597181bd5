"""Node-level chaos engine: failure domains on the virtual clock.

The paper's BeeGFS-over-DataWarp instance has a failure mode the rest of
this codebase ignored until now: storage *hardware* dies. PR 5 made
job-phase faults cheap (checkpoint-aware resume); this package supplies
the infrastructure fault domain underneath them —

* :class:`NodeFaultModel` — a seeded generator of node failure/repair
  events (exponential MTTF draws per node, repair after MTTR, plus
  optional scripted ``(t, node_id)`` kills). The orchestrator drains it
  through ordinary ``SimEngine`` events, so chaos campaigns stay
  deterministic and chaos-off campaigns schedule *nothing*.
* :class:`RetryPolicy` — deterministic exponential backoff with seeded
  jitter, shared by pool backfill and session-open retries.
* :func:`resolve_blast_radius` — maps a dead node to every live session,
  pool (and its leases), and serving replica touching it.

Everything here is duck-typed against the core/pool/serving objects and
imports none of them, so the chaos layer can never grow an import cycle
with the subsystems it breaks.
"""

from .blast import BlastRadius, resolve_blast_radius
from .faults import NodeEvent, NodeFaultModel
from .retry import RetryPolicy, drive_retries

__all__ = [
    "BlastRadius",
    "NodeEvent",
    "NodeFaultModel",
    "RetryPolicy",
    "drive_retries",
    "resolve_blast_radius",
]
