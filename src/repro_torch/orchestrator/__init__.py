"""Event-driven workflow orchestrator over the provisioning substrate.

Turns the paper's hand-driven allocate/provision/stage/run/teardown sequence
into a pipeline: jobs queue instead of failing when nodes are busy, phase
durations come from the calibrated perfmodel, faults trigger requeue, and a
campaign of hundreds of jobs simulates in milliseconds. Campaigns can draw
arrivals from a Poisson process (`arrivals`) and, with a persistent-pool
subsystem attached (`Orchestrator.enable_pools`, see ``repro.pool``), route
jobs to pools already holding their input datasets via `DataAwarePolicy`.

Fault tolerance is a first-class layer (README "Fault tolerance and
reservations"): checkpointing specs resume from their last committed step
instead of restarting, `Orchestrator.preempt` checkpoint-and-releases
RUNNING jobs for higher-priority arrivals (`PreemptionPolicy`), and
`EasyBackfillPolicy` guarantees the blocked head-of-queue job a reserved
start no backfill may delay. `Orchestrator.live_report` serves O(1)
mid-flight campaign snapshots.
"""

from ..pilot import PilotSpec, TaskSpec
from .arrivals import (
    burst_arrivals,
    diurnal_arrivals,
    exponential_interarrivals,
    mean_interarrival,
    poisson_arrivals,
    replay_trace,
)
from .engine import SimEngine
from .lifecycle import (
    TERMINAL_STATES,
    JobRecord,
    JobState,
    LiveCounters,
    Orchestrator,
    Reservation,
    WorkflowSpec,
)
from .metrics import (
    BREAKDOWN_STATES,
    CampaignReport,
    JobBreakdown,
    LiveReport,
    PoolReport,
    format_report,
    job_breakdown,
    live_report,
    pool_report,
    storage_node_utilization,
    summarize,
)
from .policies import (
    BackfillPolicy,
    DataAwarePolicy,
    EasyBackfillPolicy,
    FIFOPolicy,
    PreemptionPolicy,
    QueuePolicy,
    StorageAwarePolicy,
    VictimView,
)

__all__ = [
    "SimEngine",
    "TERMINAL_STATES", "JobRecord", "JobState", "Orchestrator", "WorkflowSpec",
    "LiveCounters", "Reservation",
    "PilotSpec", "TaskSpec",      # pilot (two-level scheduling) entry points
    "BREAKDOWN_STATES", "CampaignReport", "JobBreakdown", "LiveReport",
    "PoolReport", "format_report", "job_breakdown", "live_report",
    "pool_report", "storage_node_utilization", "summarize",
    "BackfillPolicy", "DataAwarePolicy", "EasyBackfillPolicy", "FIFOPolicy",
    "PreemptionPolicy", "QueuePolicy", "StorageAwarePolicy", "VictimView",
    "burst_arrivals", "diurnal_arrivals", "exponential_interarrivals",
    "mean_interarrival", "poisson_arrivals", "replay_trace",
]
