"""Classification metrics, the port of ``pytorch_distributed_tpu/ops/metrics.py``
(the reference's ``accuracy()``): top-k hits with an optional per-example
``weights`` mask, so padded batches count exactly."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-example 0/1 f32: the true label is within the top-k logits.

    Rank-style, as the JAX function: the true class counts as correct when
    strictly fewer than k logits beat it (a tie at the k-th place counts).
    """
    true_logit = logits.gather(-1, labels.long()[:, None])
    rank = (logits > true_logit).sum(dim=-1)
    return (rank < k).float()


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk: Sequence[int] = (1,),
             weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent over the (optionally weighted) batch, one
    scalar per k; with ``weights`` the denominator is ``max(sum(w), 1)``."""
    if weights is None:
        return tuple(topk_correct(logits, labels, k).sum() * 100.0 / labels.shape[0]
                     for k in topk)
    weights = weights.float()
    denom = weights.sum().clamp_min(1.0)
    return tuple((topk_correct(logits, labels, k) * weights).sum() * 100.0 / denom
                 for k in topk)
