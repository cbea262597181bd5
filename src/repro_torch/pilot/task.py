"""Sub-node task primitives for pilot (two-level) scheduling.

A pilot acquires a block of compute nodes plus ONE pooled storage session
through the ordinary orchestrator path, then multiplexes many *tasks* —
fractional-node units of work — inside that grant (Merzky et al., "Using
Pilot Systems to Execute Many Task Workloads on Supercomputers"). Tasks
never touch the global scheduler: they are packed, priced, retried, and
resumed entirely inside the pilot by :class:`~repro.pilot.TaskScheduler`.

Two types live here:

* :class:`TaskSpec` — the immutable description of one task kind. Campaigns
  at the million-task scale reuse a handful of spec instances across all
  their :class:`TaskRecord`\\ s (the same few-shapes/many-instances pattern
  the dispatch buckets exploit for jobs), so a spec carries everything
  per-task state does not need to duplicate.
* :class:`TaskRecord` — the per-task mutable runtime record. Deliberately
  tiny (``__slots__``, one spec reference, a few scalars): one million live
  records must fit comfortably in a CI container.

States are plain module-level ints, not an Enum — task state is flipped in
the scheduler's hottest loop and Enum attribute access costs ~10x an int
compare at this volume.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: task states (ints on purpose — see module docstring)
T_PENDING = 0
T_RUNNING = 1
T_DONE = 2
T_FAILED = 3

STATE_NAMES = ("PENDING", "RUNNING", "DONE", "FAILED")


@dataclasses.dataclass(frozen=True, slots=True)
class TaskSpec:
    """One kind of sub-node task.

    ``cores`` is the fraction of ONE compute node the task occupies
    (0.125 = an eighth of a node; 2.0 = a two-node task). The scheduler
    converts it to slots with the pilot's ``slots_per_node`` density.
    Stage bytes are the task's *private* I/O through the pilot's shared
    session — pilot-wide datasets are staged once by the session itself.
    """

    name: str
    run_time_s: float
    cores: float = 0.125
    stage_in_bytes: float = 0.0
    stage_out_bytes: float = 0.0
    max_retries: int = 2
    #: commit cadence for task-level checkpointing: on a fault or an
    #: interruption (pilot preempted, node lost) progress survives in
    #: multiples of this; ``None`` restarts the task from scratch
    checkpoint_every_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("task name must be non-empty")
        if self.run_time_s < 0:
            raise ValueError(f"{self.name}: run_time_s must be >= 0")
        if self.cores <= 0:
            raise ValueError(f"{self.name}: cores must be > 0")
        if self.stage_in_bytes < 0 or self.stage_out_bytes < 0:
            raise ValueError(f"{self.name}: stage bytes must be >= 0")
        if self.max_retries < 0:
            raise ValueError(f"{self.name}: max_retries must be >= 0")
        if self.checkpoint_every_s is not None and self.checkpoint_every_s <= 0:
            raise ValueError(f"{self.name}: checkpoint_every_s must be > 0")


@dataclasses.dataclass(slots=True)
class TaskRecord:
    """Mutable runtime state of one task instance (million-scale: keep it
    small — everything shape-like lives on the shared :class:`TaskSpec`)."""

    spec: TaskSpec
    task_id: int
    #: slots this task occupies in its pilot (ceil(cores * slots_per_node))
    slots: int
    state: int = T_PENDING
    #: fault retries consumed (interruptions/resumes do not count)
    attempt: int = 0
    #: run seconds already committed by task-level checkpoints
    committed_run_s: float = 0.0
    finished_at: float = 0.0

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]
