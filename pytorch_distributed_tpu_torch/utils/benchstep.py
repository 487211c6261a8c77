"""Train-step timing for benchmarks, the port of
``pytorch_distributed_tpu/utils/benchstep.py``.

The same discipline: warm-up steps, then a barrier before the clock starts,
then ``iters`` timed steps closed by a barrier, and a finite final loss.  On
the card the barrier is ``torch.cuda.synchronize()`` plus a fetch of the loss
value (the fetch alone would wait only for the stream the loss is on).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import torch


def _barrier(metrics: Dict[str, torch.Tensor]) -> float:
    loss = metrics["loss"]
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    return float(loss)


def measure_train_step(step, batch, lr, iters: int = 20, warmup: int = 3
                       ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Seconds per call of ``step(batch, lr) -> metrics`` (which updates its
    model in place), barrier-synchronised.  Returns ``(sec_per_step, last
    metrics)``; raises AssertionError if the final loss is not finite."""
    for _ in range(warmup):
        metrics = step(batch, lr)
    if warmup:
        _barrier(metrics)  # drain the queue before t0
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = step(batch, lr)
    assert math.isfinite(_barrier(metrics))
    return (time.perf_counter() - t0) / iters, metrics


def looks_like_oom(err: BaseException) -> bool:
    """Heuristic: is this a memory-capacity failure a smaller batch could
    fix (vs a deterministic error retrying cannot)?"""
    text = f"{type(err).__name__}: {err}"
    needles = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "OOM", "Attempting to allocate", "vmem", "VMEM",
               "exceeds the limit", "Ran out of memory", "OutOfMemoryError")
    return any(n in text for n in needles)
