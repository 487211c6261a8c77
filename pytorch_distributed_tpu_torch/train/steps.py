"""Image train and eval steps, the port of the ``global_step``,
``local_step`` and ``make_eval_step`` of ``pytorch_distributed_tpu/train/steps.py``.

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
- ``make_eval_step``: exact weighted sums for the host to aggregate (all
  ranks' sums under a process group).

Under a process group (one rank per process, each holding its shard of the
global batch) the step takes one of the two JAX expressions:

- **GSPMD twin** (default; every recipe but Horovod): the model in DDP
  (``broadcast_buffers=False``), its BatchNorm over the global batch
  (``ResNet.set_bn_group``: moments averaged, through-stats sums of the
  backward summed, also for K4/K5's vectors), the gradients all-reduced as
  sums by a comm hook and divided once by the global weight count, the
  metric sums all-reduced.  Each rank's microbatch i is its shard of the
  global microbatch i, so accumulation and BatchNorm match the JAX step on
  the global batch.  ``grad_compress="bf16"`` rounds the averaged gradients
  through bf16, as the JAX step's numerics-only emulation does.
- **explicit twin** (``explicit_collectives``; the JAX ``local_step`` of
  ``horovod_distributed``): per-rank BatchNorm, or with ``sync_bn`` (the
  JAX ``bn_axis_name``) BatchNorm over the global batch through
  ``set_bn_group``, the local weighted gradient sums all-reduced by hand
  (cast to bf16 on the wire under ``grad_compress="bf16"``), divided in
  f32 by the global count, the BN running statistics averaged over the
  ranks after the step.  The GSPMD twin's BatchNorm is global already, so
  there, and without a group, ``sync_bn`` changes nothing.

``int8``/``fp8`` wire formats, ZeRO and bucketed overlap belong to the
gradient-communication stack (ROADMAP.md item A9).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.ops.metrics import topk_correct

Batch = Dict[str, torch.Tensor]
WIRE_DTYPES = {None: None, "none": None, "bf16": torch.bfloat16}


def _sum_hook(group, bucket):
    """DDP comm hook: the bucket's gradients summed over the ranks (DDP's
    default divides by the world size first)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def data_parallel(model, group) -> DistributedDataParallel:
    """``model`` in DDP over ``group`` with the JAX GSPMD step's semantics:
    global-batch BatchNorm, summed gradients, no buffer broadcast (every
    rank computes the same running statistics)."""
    model.set_bn_group(group)
    dev = next(model.parameters()).device
    net = DistributedDataParallel(model, device_ids=[dev.index] if dev.type == "cuda" else None,
                                  process_group=group, broadcast_buffers=False)
    net.register_comm_hook(group, _sum_hook)
    return net


def _all_reduce_flat(tensors: List[torch.Tensor], group, wire: Optional[torch.dtype]):
    """The tensors summed over ``group`` through one flat buffer (cast to
    ``wire`` for the collective), returned in f32."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if wire is not None:
        flat = flat.to(wire)
    dist.all_reduce(flat, group=group)
    flat = flat.float()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


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
                    log_norms: bool = False, guard_nonfinite: bool = False, group=None,
                    explicit_collectives: bool = False, grad_compress: Optional[str] = None,
                    sync_bn: bool = False):
    """``step(batch, lr) -> metrics`` (device scalars: ``loss``, ``acc1``,
    ``acc5`` in percent; ``nonfinite`` under ``guard_nonfinite``;
    ``grad_norm`` and ``param_norm`` under ``log_norms``).  ``group``: the
    process group of data parallelism (None: one device), with the GSPMD
    twin or, under ``explicit_collectives``, the explicit one, whose
    BatchNorm ``sync_bn`` makes global."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_compress not in WIRE_DTYPES:
        raise ValueError(f"grad_compress {grad_compress!r}: none or bf16 (int8 and fp8 are "
                         "ROADMAP.md item A9)")
    wire = WIRE_DTYPES[grad_compress]
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = list(model.buffers())
    stats = [b for b in buffers if b.is_floating_point()]
    gspmd = group is not None and not explicit_collectives
    net = data_parallel(model, group) if gspmd else model
    if sync_bn and explicit_collectives and group is not None:
        model.set_bn_group(group)

    def momentum_buffers() -> List[torch.Tensor]:
        return [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]

    def step(batch: Batch, lr: float) -> Dict[str, torch.Tensor]:
        net.train()
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
            # DDP reduces once, after the last microbatch's backward.
            defer = gspmd and i < accum_steps - 1
            with net.no_sync() if defer else contextlib.nullcontext():
                mb_loss, mb_c1, mb_c5, mb_count = forward_and_sums(net, mb)
                mb_loss.backward()  # .grad holds the sum over microbatches
            loss_sum = loss_sum + mb_loss.detach()
            c1, c5, count = c1 + mb_c1, c5 + mb_c5, count + mb_count
        if group is not None:
            sums = torch.stack([loss_sum, c1, c5, count]).float()
            dist.all_reduce(sums, group=group)
            loss_sum, c1, c5, count = sums
        if explicit_collectives:
            # The JAX local_step: the local weighted sums on the wire, the
            # global count divides them in f32 (no clamp, as there).
            grads = [p.grad for p in params]
            if group is not None:
                grads = _all_reduce_flat(grads, group, wire)
            elif wire is not None:
                grads = [g.to(wire).float() for g in grads]
            for p, g in zip(params, grads):
                p.grad = g / count
        else:
            count = count.clamp_min(1.0)
            for p in params:
                p.grad.div_(count)
                if wire is not None:
                    p.grad = p.grad.to(wire).float()
        gnorm = _l2_norm(p.grad for p in params) if (log_norms or guard_nonfinite) else None
        metrics = {"loss": loss_sum / count, "acc1": c1 * 100.0 / count,
                   "acc5": c5 * 100.0 / count}
        if guard_nonfinite:
            old_params = [p.detach().clone() for p in params]
            old_moms = [torch.zeros_like(p) if m is None else m.clone()
                        for p, m in zip(params, momentum_buffers())]
        for pg in optimizer.param_groups:
            pg["lr"] = lr
        optimizer.step()
        if explicit_collectives and group is not None and stats:
            # BN running statistics: the ranks' EMAs averaged (JAX pmean).
            world = dist.get_world_size(group)
            with torch.no_grad():
                for b_, avg in zip(stats, _all_reduce_flat(stats, group, None)):
                    b_.copy_(avg / world)
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


def make_eval_step(model, group=None):
    """``step(batch) -> {"loss_sum", "correct1", "correct5", "count"}`` with
    the model in eval mode (running BN statistics), no gradients; under
    ``group``, the sums of all its ranks."""

    @torch.no_grad()
    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        loss_sum, c1, c5, count = forward_and_sums(model, batch)
        if group is not None:
            sums = torch.stack([loss_sum, c1, c5, count]).float()
            dist.all_reduce(sums, group=group)
            loss_sum, c1, c5, count = sums
        return {"loss_sum": loss_sum, "correct1": c1, "correct5": c5, "count": count}

    return step
