"""LR schedules: pure functions of the step (a tensor or a number),
returning an fp32 tensor on the step's device."""

from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def constant(base_lr: float):
    # a fill on the step's device: no host-to-device copy
    return lambda step: torch.full(
        (), base_lr, dtype=torch.float32,
        device=step.device if isinstance(step, torch.Tensor) else None)
