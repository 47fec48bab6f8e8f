"""Learning-rate schedules: the port of the JAX package's
``repro.optim.schedules``.  Each is a function of a step (an int or a
tensor) that returns the multiplier as a float32 tensor (0-d for an int
step, on the step's device for a tensor)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(value: float = 1.0):
    return lambda step: torch.full_like(_step(step), value)


def linear_warmup(warmup_steps: int, base: float = 1.0):
    def fn(step):
        s = _step(step)
        return base * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_decay(decay_steps: int, base: float = 1.0, floor: float = 0.0):
    def fn(step):
        s = torch.clamp(_step(step), 0, decay_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * s / max(decay_steps, 1)))
        return floor + (base - floor) * cos
    return fn


def warmup_cosine(warmup_steps: int, total_steps: int, base: float = 1.0,
                  floor: float = 0.0):
    """The production default: linear warmup then cosine to ``floor``."""
    warm = linear_warmup(warmup_steps, base)
    decay = cosine_decay(max(total_steps - warmup_steps, 1), base, floor)

    def fn(step):
        s = _step(step)
        return torch.where(s < warmup_steps, warm(s), decay(s - warmup_steps))
    return fn
