"""Learning-rate schedules (the twin of ``repro.optim.schedules``).

Each schedule maps the int32 step count (a 0-d tensor, as
:class:`~repro_torch.optim.base.ScaleByScheduleState` holds it) to a
float32 0-d tensor on the count's device.
"""
from __future__ import annotations

import math

import torch


def constant_schedule(value: float):
    return lambda count: torch.full((), value, dtype=torch.float32, device=count.device)


def warmup_schedule(base: float, warmup_steps: int):
    def schedule(count):
        frac = torch.clamp((count.float() + 1.0) / max(warmup_steps, 1), max=1.0)
        return base * frac

    return schedule


def cosine_decay_schedule(base: float, decay_steps: int, alpha: float = 0.0):
    def schedule(count):
        frac = torch.clamp(count.float() / max(decay_steps, 1), 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base * ((1.0 - alpha) * cosine + alpha)

    return schedule


def linear_warmup_cosine_decay(base: float, warmup_steps: int, total_steps: int,
                               alpha: float = 0.0):
    cos = cosine_decay_schedule(base, max(total_steps - warmup_steps, 1), alpha)

    def schedule(count):
        warm = base * (count.float() + 1.0) / max(warmup_steps, 1)
        return torch.where(count < warmup_steps, warm, cos(count - warmup_steps))

    return schedule
