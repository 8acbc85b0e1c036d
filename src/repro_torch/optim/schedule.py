"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor x peak`` at ``total``. ``step`` is an int or a scalar
    tensor; returns an f32 scalar tensor (on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
