"""Learning-rate schedules (port of `repro.optim.schedule`)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
):
    """step (an integer tensor) -> float32 learning rate on its device:
    linear warm-up, then a cosine from ``base_lr`` down to ``min_ratio``
    of it, in the reference's float32 order of operations. The divisors
    are tensors: on CUDA a division by a Python scalar is a multiply by
    its reciprocal."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / torch.tensor(max(1.0, warmup_steps), dtype=torch.float32, device=s.device)
        span = torch.tensor(max(1.0, total_steps - warmup_steps), dtype=torch.float32,
                            device=s.device)
        frac = torch.clamp((s - warmup_steps) / span, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * torch.where(s < warmup_steps, warm, cos)

    return fn
