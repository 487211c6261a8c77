"""Image train and eval steps on one device, the port of the GSPMD
``global_step`` and ``make_eval_step`` of ``pytorch_distributed_tpu/train/steps.py``.

- ``forward_and_sums``: the weighted loss sum (``cross_entropy`` with the
  padding mask times the weight count) and the top-1 / top-5 hit sums over
  the mask.
- ``make_train_step``: gradients of the mean over the weight count (the sum
  form divided once), optional strided gradient accumulation (microbatch i
  is samples ``i::accum_steps``; each microbatch's forward updates the BN
  running statistics in turn, as the JAX scan carries them), then the
  reference SGD (``train/optim.py``, every parameter decayed, BN scales and
  biases included).  ``guard_nonfinite`` gates the whole update on a finite
  loss and gradient norm, restoring parameters, momentum and BN buffers on
  the device without a host sync; ``log_norms`` adds the gradient and
  parameter norms.  The JAX step returns a new train state; this one
  updates the model and optimizer in place.
- ``make_eval_step``: exact weighted sums for the host to aggregate.

Gradient sync, wire compression, ZeRO and the explicit-collectives step
belong to the distribution slice (ROADMAP.md items A9 and A18).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.ops.metrics import topk_correct

Batch = Dict[str, torch.Tensor]


def _l2_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm with f32 accumulation (the JAX ``tree_l2_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def forward_and_sums(model, batch: Batch):
    """``(loss_sum, c1, c5, count)``: weighted sums over the batch's padding
    mask, in the model's current mode."""
    logits = model(batch["images"])
    w = batch["weights"].float()
    labels = batch["labels"]
    count = w.sum()
    loss_sum = cross_entropy(logits, labels, weights=w) * count
    with torch.no_grad():
        c1 = (topk_correct(logits, labels, 1) * w).sum()
        c5 = (topk_correct(logits, labels, 5) * w).sum()
    return loss_sum, c1, c5, count


def make_train_step(model, optimizer: torch.optim.Optimizer, accum_steps: int = 1,
                    log_norms: bool = False, guard_nonfinite: bool = False):
    """``step(batch, lr) -> metrics`` (device scalars: ``loss``, ``acc1``,
    ``acc5`` in percent; ``nonfinite`` under ``guard_nonfinite``;
    ``grad_norm`` and ``param_norm`` under ``log_norms``)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = list(model.buffers())

    def momentum_buffers() -> List[torch.Tensor]:
        return [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]

    def step(batch: Batch, lr: float) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if guard_nonfinite:
            old_buffers = [b.clone() for b in buffers]
        b = batch["images"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch dimension {b} is not divisible by accum_steps "
                             f"{accum_steps}")
        loss_sum = c1 = c5 = count = 0.0
        for i in range(accum_steps):
            # Strided split: microbatch i = samples [i::accum_steps].
            mb = batch if accum_steps == 1 else {k: v[i::accum_steps] for k, v in batch.items()}
            mb_loss, mb_c1, mb_c5, mb_count = forward_and_sums(model, mb)
            mb_loss.backward()  # .grad holds the sum over microbatches
            loss_sum = loss_sum + mb_loss.detach()
            c1, c5, count = c1 + mb_c1, c5 + mb_c5, count + mb_count
        count = count.clamp_min(1.0)
        for p in params:
            p.grad.div_(count)
        gnorm = _l2_norm(p.grad for p in params) if (log_norms or guard_nonfinite) else None
        metrics = {"loss": loss_sum / count, "acc1": c1 * 100.0 / count,
                   "acc5": c5 * 100.0 / count}
        if guard_nonfinite:
            old_params = [p.detach().clone() for p in params]
            old_moms = [torch.zeros_like(p) if m is None else m.clone()
                        for p, m in zip(params, momentum_buffers())]
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        if guard_nonfinite:
            bad = ~(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            with torch.no_grad():
                for new, old in zip([p.data for p in params] + momentum_buffers() + buffers,
                                    old_params + old_moms + old_buffers):
                    new.copy_(torch.where(bad, old, new))
            metrics["nonfinite"] = bad.float()
        if log_norms:
            metrics["grad_norm"] = gnorm
            with torch.no_grad():
                metrics["param_norm"] = _l2_norm(params)
        return metrics

    return step


def make_eval_step(model):
    """``step(batch) -> {"loss_sum", "correct1", "correct5", "count"}`` with
    the model in eval mode (running BN statistics), no gradients."""

    @torch.no_grad()
    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        loss_sum, c1, c5, count = forward_and_sums(model, batch)
        return {"loss_sum": loss_sum, "correct1": c1, "correct5": c5, "count": count}

    return step
