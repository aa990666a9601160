"""Learning-rate schedules (the port's copy of ``repro/optim/schedules.py``):
step -> lr, computed in f32 as the reference computes it and returned as a
Python float (the f32 value), so an optimizer update reads no device scalar."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    """The step as a 0-d f32 CPU tensor (an int or a 0-d tensor)."""
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def sched(step) -> float:
        s = _step_f32(step)
        return float(peak * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0))

    return sched


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup then cosine decay to floor*peak."""

    def sched(step) -> float:
        s = _step_f32(step)
        warm = peak * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return float(torch.where(s < warmup_steps, warm, cos))

    return sched
