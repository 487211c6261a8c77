"""Loss functions, the port of ``pytorch_distributed_tpu/ops/loss.py``.

Softmax cross-entropy from integer labels, mean-reduced, with the JAX
package's optional per-example ``weights`` (padded static-shape batches)
and ``label_smoothing``.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over ``logits [N, C]`` and ``labels [N]``.

    Logits are promoted to f32 before the logsumexp, so bf16 logits give
    the loss scale of an f32 run.  With ``weights`` the mean is
    ``sum(loss * w) / max(sum(w), 1)``.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    per_example = logz - true_logit
    if label_smoothing > 0.0:
        # Smoothed target = (1-eps)*onehot + eps*uniform; CE against it is
        # the hard-label term plus the uniform term below.
        smooth = logz - logits.mean(dim=-1)
        per_example = (1.0 - label_smoothing) * per_example + label_smoothing * smooth
    if weights is None:
        return per_example.mean()
    weights = weights.float()
    return (per_example * weights).sum() / weights.sum().clamp_min(1.0)
