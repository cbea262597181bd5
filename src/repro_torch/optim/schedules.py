"""LR schedules as pure functions step -> multiplier (applied to cfg.lr),
float32 as in ``src/repro/optim/schedules.py``."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step) -> torch.Tensor:
    return torch.ones_like(torch.as_tensor(step, dtype=torch.float32))
