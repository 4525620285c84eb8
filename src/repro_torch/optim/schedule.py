"""Learning-rate schedules (pure functions of the step counter; PyTorch port
of ``repro.optim.schedule``).

Each takes the step as an int or a tensor and returns a float32 scalar
tensor on the step's device, so a training step that reads the step from
its optimizer state on the card never waits for the host.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, warmup: int = 200, total: int = 10_000, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak (scale in [0,1])."""
    step = _step(step)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def constant(step):
    return torch.ones_like(_step(step))
