"""Learning-rate schedules, counterparts of `repro.optim.schedules`: each
maps a step (a 0-d tensor) to an fp32 0-d tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return fn


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int,
                         floor: float = 0.0):
    cos = cosine_decay(peak, max(total_steps - warmup, 1), floor)

    def fn(step):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return fn
