"""LR schedules (scale factors composed with ``AdamWConfig.lr``) — the
port of the JAX package's ``repro/optim/schedule.py``. A schedule takes
the train state's ``step`` (an int32 0-d tensor) and returns an f32 0-d
tensor on its device, computed there: no host read-back."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return warm * cos
    return schedule


def constant():
    def schedule(step):
        return 1.0
    return schedule
