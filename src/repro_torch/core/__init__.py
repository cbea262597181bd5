"""Core: the paper's contribution — dynamically provisioned, job-scoped
data managers on schedulable storage resources (Tessier et al., 2019)."""

from .client import FSClient
from .datamanager import DataManager, FSError, FileStat, ServiceInfo
from .ephemeralfs import CacheSim, EphemeralFS
from .globalfs import GlobalFS
from .kvstore import EphemeralKV
from .perfmodel import (
    BWResult,
    FSDeployment,
    TPU_V5E,
    TPUProfile,
    Workload,
    ault_efs,
    dom_efs,
    dom_lustre,
    hacc_workload,
    predict,
    predict_deploy_time,
    predict_mdtest,
    predict_read,
    predict_write,
)
from .provisioner import Deployment, DeploymentPlan, Provisioner
from .resources import (
    ClusterSpec,
    ComputeNode,
    Disk,
    DiskSpec,
    InterconnectSpec,
    StorageNode,
    ault_cluster,
    dom_cluster,
    synthetic_cluster,
    tpu_pod_cluster,
)
from .scheduler import (
    Allocation,
    AllocationError,
    JobRequest,
    Scheduler,
    SizingPolicy,
    StorageRequest,
    size_for_checkpoint,
)
from .staging import StageReport, modeled_stage_time, stage, stage_tree
from .striping import Extent, StripeConfig, bytes_per_target, extents_for_range

__all__ = [
    "FSClient", "DataManager", "FSError", "FileStat", "ServiceInfo",
    "CacheSim", "EphemeralFS", "EphemeralKV", "GlobalFS",
    "BWResult", "FSDeployment", "TPU_V5E", "TPUProfile", "Workload",
    "ault_efs", "dom_efs", "dom_lustre", "hacc_workload",
    "predict", "predict_deploy_time", "predict_mdtest", "predict_read", "predict_write",
    "Deployment", "DeploymentPlan", "Provisioner",
    "ClusterSpec", "ComputeNode", "Disk", "DiskSpec", "InterconnectSpec",
    "StorageNode", "ault_cluster", "dom_cluster", "synthetic_cluster",
    "tpu_pod_cluster",
    "Allocation", "AllocationError", "JobRequest", "Scheduler", "SizingPolicy",
    "StorageRequest", "size_for_checkpoint",
    "StageReport", "modeled_stage_time", "stage", "stage_tree",
    "Extent", "StripeConfig", "bytes_per_target", "extents_for_range",
]
