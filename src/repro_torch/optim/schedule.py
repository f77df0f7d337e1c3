"""LR schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``.  A schedule takes the step as a tensor and
returns the rate as a 0-dim fp32 tensor on the step's device, so a train
step never waits on the host for its learning rate.
"""
from __future__ import annotations

import math

import torch


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


def warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
):
    """Linear warmup then cosine decay to ``min_ratio * peak``."""

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32, device=_device(step))
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=_device(step))
