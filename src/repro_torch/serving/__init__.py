"""SLO-aware pool-backed model serving on the provisioning substrate.

The ROADMAP's first serving milestone: model weights are a dataset staged
**once** into a PERSISTENT pool; replicas are POOLED leases plus a
continuous-batching token loop; traffic follows seeded diurnal/burst
arrival laws; and an :class:`Autoscaler` grows and drains the fleet by
consuming the PR 7 ``AlertEngine``'s incident lifecycle. Everything runs
on the orchestrator's :class:`SimEngine` virtual clock and is traced
through the PR 6 recorder, so campaigns replay bit-identically.

Hot-path layering rule (enforced by ``tools/check_obs_imports.py``): these
modules may import only ``repro.obs.trace`` from the observability package
at module level.
"""

from .autoscale import Autoscaler, AutoscalerConfig, ScaleDecision
from .batching import BatchEngine, ServingPerf
from .campaign import (
    ServingCampaign,
    ServingReport,
    format_serving_report,
)
from .replica import ModelProfile, Replica, ReplicaSet, ReplicaState
from .workload import LengthDist, Request, synthesize_requests

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ScaleDecision",
    "BatchEngine", "ServingPerf",
    "ServingCampaign", "ServingReport", "format_serving_report",
    "ModelProfile", "Replica", "ReplicaSet", "ReplicaState",
    "LengthDist", "Request", "synthesize_requests",
]
