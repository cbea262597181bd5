"""Carry parameters from ``repro``'s tree of arrays into the port.

``repro``'s params are nested dicts of arrays; handed over as nested dicts of
numpy arrays, they become the port's nested dicts of tensors with the same
key paths and the same stacked leading layer dims (``layers/attn/wq/w`` is
(L, d, H*hd) on both sides). numpy has no bfloat16 of its own, so a caller
holding bf16 arrays widens them to float32 first and passes ``dtype``.

``repro`` keeps some leaves in float32 whatever the config's dtype: Mamba2's
``dt_bias``, ``A_log`` and ``D`` (``src/repro/models/mamba2.py:mamba_init``),
matched by leaf name, and the MoE router's weight (``moe_init``) and the
mLSTM's gate projection (``src/repro/models/xlstm.py:mlstm_init``), matched
by key path, since their leaves are called ``w`` and ``b`` like every dense
layer's. Those stay float32 when ``dtype`` asks for another type; the dense
tree has none of them.

``train_state_from_numpy`` carries a whole ``repro`` ``TrainState`` across
(params, the ``OptState``'s step, fp32 master, m and v, and the error-feedback
residuals), so that both packages can take the same training step.
"""

from __future__ import annotations

import numpy as np
import torch

FLOAT32_LEAVES = frozenset({"dt_bias", "A_log", "D"})     # by leaf name
FLOAT32_PATHS = ("moe/router/w", "mlstm/w_gates/w", "mlstm/w_gates/b")   # by the path's end


def keeps_float32(path: str) -> bool:
    """Whether the leaf at ``/``-joined key ``path`` stays float32."""
    return (path.rsplit("/", 1)[-1] in FLOAT32_LEAVES
            or any(path == p or path.endswith("/" + p) for p in FLOAT32_PATHS))


def from_numpy(tree, *, device="cpu", dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``,
    cast to ``dtype`` where given, except the leaves ``keeps_float32`` names,
    which are float32."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))      # a writable, contiguous copy
        if dtype is None:
            return t.to(device)
        return t.to(device=device, dtype=torch.float32 if keeps_float32(path) else dtype)
    return walk(tree, "")


def train_state_from_numpy(state, *, device="cpu", dtype: torch.dtype | None = None):
    """A ``repro`` ``TrainState`` whose leaves are numpy arrays (bf16 ones
    widened to float32) -> the port's ``TrainState``: params cast to
    ``dtype`` as ``from_numpy`` does, the optimizer state and residuals in
    float32, the step an int32 scalar."""
    from .optim import ErrorFeedback, OptState
    from .runtime import TrainState
    f32 = dict(device=device, dtype=torch.float32)
    opt = state.opt
    new_opt = OptState(torch.tensor(np.asarray(opt.step), dtype=torch.int32, device=device),
                       from_numpy(opt.master, **f32), from_numpy(opt.m, **f32),
                       from_numpy(opt.v, **f32))
    ef = ErrorFeedback(from_numpy(state.ef.residual, **f32)) if state.ef else ()
    return TrainState(from_numpy(state.params, device=device, dtype=dtype), new_opt, ef)
