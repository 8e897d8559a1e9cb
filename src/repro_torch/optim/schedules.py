"""Learning-rate schedules, on a step tensor in float32 as the JAX
package computes them."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return lr
