"""Step functions, sharding rules, fault tolerance and cost extraction: the
port of ``src/repro/runtime/``. ``repro``'s ``jit_*`` steps are ``shard_*``
here (``parallel.py``); ``hlo_collective_bytes`` is ``collective_bytes``
(``costs.py``)."""

from .costs import collective_bytes, step_costs
from .fault import FaultInjector, FaultSpec, HeartbeatMonitor, RestartPlan, plan_restart
from .parallel import (
    RuntimeConfig,
    TrainState,
    distribute_tree,
    loss_and_grads,
    make_decode_step,
    make_prefill,
    make_train_state,
    make_train_step,
    shard_decode_step,
    shard_prefill,
    shard_train_step,
    train_state_shardings,
)
from .sharding import (
    batch_shardings,
    cache_shardings,
    dp_axes,
    opt_shardings,
    param_shardings,
    param_spec,
)

__all__ = [
    "collective_bytes", "step_costs",
    "FaultInjector", "FaultSpec", "HeartbeatMonitor", "RestartPlan", "plan_restart",
    "RuntimeConfig", "TrainState", "distribute_tree", "loss_and_grads",
    "make_decode_step", "make_prefill", "make_train_state", "make_train_step",
    "shard_decode_step", "shard_prefill", "shard_train_step", "train_state_shardings",
    "batch_shardings", "cache_shardings", "dp_axes", "opt_shardings",
    "param_shardings", "param_spec",
]
