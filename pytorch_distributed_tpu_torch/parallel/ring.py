"""Single-device attention semantics of ``pytorch_distributed_tpu/parallel/ring.py``.

Only ``dense_attention`` is ported so far; ring attention over a sequence
axis comes with model parallelism.
"""

from __future__ import annotations

import torch

from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention_reference


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over [B, L, H, D] with f32 scores and softmax; the output
    is cast back to q's dtype."""
    return flash_attention_reference(q, k, v, causal)[0]
