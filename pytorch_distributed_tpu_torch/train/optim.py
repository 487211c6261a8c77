"""SGD with the reference optimizer's semantics, the port of
``pytorch_distributed_tpu/train/optim.py``.

The JAX package reimplements ``torch.optim.SGD(lr, momentum=0.9,
weight_decay=1e-4)`` as pure functions over pytrees:

- weight decay is coupled (added to the gradient): ``g = g + wd * p``;
- momentum buffer: ``buf = mu * buf + g`` (from a zero buffer, so the first
  step's buffer is ``g``; dampening 0, no Nesterov, no bias correction);
- update: ``p = p - lr * buf``.

``torch.optim.SGD`` with ``dampening=0`` and ``nesterov=False`` has exactly
these semantics (its first step copies ``g`` into the buffer, which equals
``mu * 0 + g``), so the port uses it as it is; the parity test against the
JAX ``sgd_update`` holds it to that.  Weight decay applies to every
parameter, LayerNorm scales and biases included, as the JAX tree map does.
Parameters are the f32 master copy; ``lr`` is set on the param group before
each step.
"""

from __future__ import annotations

from typing import Iterable

import torch


def sgd(params: Iterable[torch.nn.Parameter], lr: float = 1e-2,
        momentum: float = 0.9, weight_decay: float = 1e-4) -> torch.optim.SGD:
    """The reference SGD over ``params`` (one param group, all decayed)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay, nesterov=False)
