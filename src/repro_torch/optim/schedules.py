"""Learning-rate schedules as functions of the step counter (the JAX
package's ``optim/schedules.py``).  ``step`` is an integer tensor (the
optimizer's ``count``, on its device); the result is an f32 tensor on
the same device, so a train step reads no value back to the host."""
from __future__ import annotations

import math

import torch


def linear_warmup(step: torch.Tensor, base_lr: float,
                  warmup_steps: int) -> torch.Tensor:
    frac = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
    return base_lr * frac


def cosine_schedule(step: torch.Tensor, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    warm = linear_warmup(step, base_lr, warmup_steps)
    t = torch.clamp((step.float() - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
