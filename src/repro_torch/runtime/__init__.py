"""Step builders (single device): the port of ``src/repro/runtime/``."""

from .parallel import (
    RuntimeConfig,
    TrainState,
    loss_and_grads,
    make_decode_step,
    make_prefill,
    make_train_state,
    make_train_step,
)

__all__ = ["RuntimeConfig", "TrainState", "loss_and_grads", "make_decode_step",
           "make_prefill", "make_train_state", "make_train_step"]
