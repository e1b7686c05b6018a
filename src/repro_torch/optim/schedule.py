"""Learning-rate schedules as step -> lr callables on a step tensor (twin of
``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(torch.as_tensor(step).float() / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return lr
