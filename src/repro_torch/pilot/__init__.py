"""Pilot-style many-task execution (two-level scheduling).

Top level: one :class:`PilotSpec` job acquires a compute block plus one
pooled storage session through the ordinary orchestrator path
(``Orchestrator.submit_pilot``). Bottom level: the in-pilot
:class:`TaskScheduler` packs thousands of sub-node :class:`TaskSpec` s into
the pilot's slots, prices whole waves through the session's performance
model, and coalesces completions so the engine sees O(1) amortized events
per batch instead of a full job lifecycle per task.
"""

from .run import PilotRun, PilotSpec
from .scheduler import TaskScheduler, TaskStats
from .task import (
    STATE_NAMES,
    T_DONE,
    T_FAILED,
    T_PENDING,
    T_RUNNING,
    TaskRecord,
    TaskSpec,
)

__all__ = [
    "PilotRun",
    "PilotSpec",
    "TaskScheduler",
    "TaskStats",
    "TaskRecord",
    "TaskSpec",
    "T_PENDING",
    "T_RUNNING",
    "T_DONE",
    "T_FAILED",
    "STATE_NAMES",
]
