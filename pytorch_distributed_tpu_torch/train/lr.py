"""Learning-rate schedules, a copy of ``pytorch_distributed_tpu/train/lr.py``
(pure host functions of the epoch; the reference's ``adjust_learning_rate``
is ``step_decay_lr``)."""

from __future__ import annotations

import math


def step_decay_lr(base_lr: float, epoch: int, decay_factor: float = 0.1,
                  decay_every: int = 30) -> float:
    """``lr = base_lr * decay_factor ** (epoch // decay_every)``."""
    return base_lr * (decay_factor ** (epoch // decay_every))


def cosine_lr(base_lr: float, epoch: int, total_epochs: int, warmup_epochs: int = 0,
              min_lr: float = 0.0) -> float:
    """Linear warmup that reaches ``base_lr`` at ``warmup_epochs`` (every
    warmup epoch runs reduced), then a half cosine to ``min_lr`` at
    ``total_epochs``."""
    if warmup_epochs > 0 and epoch < warmup_epochs:
        return base_lr * (epoch + 1) / (warmup_epochs + 1)
    span = max(1, total_epochs - warmup_epochs)
    t = min(max(epoch - warmup_epochs, 0), span) / span
    return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))


def linear_scaled_lr(base_lr: float, global_batch: int, base_batch: int = 256) -> float:
    """The linear-scaling rule (Goyal et al.); off by default."""
    return base_lr * global_batch / base_batch
