"""Learning-rate schedules and the twin-learners strategy.

Counterpart of ``repro/optim/schedules.py``.  Twin learners (Chin et al.,
PAKDD'15, the paper's §5.3) freeze the trailing latent dimensions during the
first epoch, so under an adaptive optimizer their accumulators stay empty and
they later train with an effectively fresh learning rate.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: lr


def cosine(lr: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


def twin_learners_mask(k: int, epoch: int, twin_fraction: float = 0.5,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-dimension update mask: in the first epoch (``epoch == 0``) the
    trailing ``twin_fraction`` of latent dims is frozen; later all train.
    Composes multiplicatively with Algorithm 3's pruning mask."""
    if epoch > 0:
        return torch.ones((k,), dtype=dtype, device=device)
    cut = int(round(k * (1.0 - twin_fraction)))
    return (torch.arange(k, device=device) < cut).to(dtype)
