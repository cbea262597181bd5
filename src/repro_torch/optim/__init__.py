"""Optimizer, LR schedules and gradient compression: the port of
``src/repro/optim/`` on nested dicts of tensors."""

from .adamw import AdamWConfig, OptState, global_norm, init, update
from .compression import ErrorFeedback, compress_grads, int8_allreduce
from .compression import init as ef_init
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig", "OptState", "global_norm", "init", "update",
    "ErrorFeedback", "compress_grads", "ef_init", "int8_allreduce", "constant", "warmup_cosine",
]
