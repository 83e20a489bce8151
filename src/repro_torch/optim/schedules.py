"""Learning-rate schedules (twin of ``repro.optim.schedules``): float32
functions of the step, computed in torch as the reference's jnp, so the
rate at every step equals the reference's.

``step`` is an int or an integer tensor; the result is a 0-d float32
tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step)


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    frac = torch.clamp(_steps(step) / max(1, total_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * (min_ratio + (1 - min_ratio) * cos)


def linear_warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = _steps(step)
    warm = base_lr * torch.clamp(step / max(1, warmup_steps), max=1.0)
    decay = cosine_schedule(torch.clamp(step - warmup_steps, min=0),
                            base_lr=base_lr,
                            total_steps=max(1, total_steps - warmup_steps),
                            min_ratio=min_ratio)
    return torch.where(step < warmup_steps, warm, decay)
