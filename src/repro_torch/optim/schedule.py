"""LR schedules (port of `repro/optim/schedule.py`)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_frac; returns the LR scale,
    a 0-d f32 tensor on the step's device, computed in f32. At step 0 it
    is 0, so a run's first update has a learning rate of 0, as in the
    reference. The divisors are f32 tensors: on the card, PyTorch divides
    by a Python number as a multiply by its reciprocal."""
    step = torch.as_tensor(step).to(torch.float32)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=step.device)

    warm = torch.clamp(step / f32(max(warmup, 1)), max=1.0)
    prog = torch.clamp((step - warmup) / f32(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
