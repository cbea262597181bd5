"""Step functions, sharding rules and fault tolerance: the port of
``src/repro/runtime/`` (the cost layer, ``costs.py``, is not ported yet).
``repro``'s ``jit_*`` steps are ``shard_*`` here (``parallel.py``)."""

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
    "FaultInjector", "FaultSpec", "HeartbeatMonitor", "RestartPlan", "plan_restart",
    "RuntimeConfig", "TrainState", "distribute_tree", "loss_and_grads",
    "make_decode_step", "make_prefill", "make_train_state", "make_train_step",
    "shard_decode_step", "shard_prefill", "shard_train_step", "train_state_shardings",
    "batch_shardings", "cache_shardings", "dp_axes", "opt_shardings",
    "param_shardings", "param_spec",
]
