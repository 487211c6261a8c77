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

Dropout (the zoo's ``models/layers.py::Dropout``) draws its masks from the
``DropoutKey`` the step sets before each microbatch's forward: ``(seed,
step.count, microbatch)`` as the JAX ``fold_in(base_key, state.step)`` and
``fold_in(rng, i)``, with this rank folded in on the explicit step (the
JAX ``fold_in(..., axis_index)``) and, on the GSPMD twin, the global
batch's mask of which this rank keeps its rows.  ``step.count`` (the steps
taken; the trainer restores it on resume) is all the state the masks
have.

Under a process group (one rank per process, each holding its shard of the
global batch) the step takes one of the two JAX expressions:

- **GSPMD twin** (default; every recipe but Horovod): the model in DDP
  (``broadcast_buffers=False``), its BatchNorm over the global batch
  (the model's ``set_bn_group``: moments averaged, through-stats sums of the
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

The gradient-communication stack (``train/gradsync.py``) rides on both:
``grad_compress="int8"|"fp8"`` is the quantized all-reduce with error
feedback on the explicit step and its numerics emulation on the averaged
gradient under GSPMD; ``zero="wus"`` replaces the all-reduce (and DDP) by
a reduce-scatter, the SGD on this rank's 1/N of every leaf and an
all-gather; ``overlap="bucketed"`` (explicit only) starts each bucket's
collective from the backward's hooks.  The JAX step's refusals come first,
in its words.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.models.layers import (DropoutKey, dropout_layers,
                                                          set_dropout_key)
from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.ops.metrics import topk_correct
from pytorch_distributed_tpu_torch.parallel import overlap as overlap_lib
from pytorch_distributed_tpu_torch.parallel import zero as zero_lib
from pytorch_distributed_tpu_torch.train.gradsync import GradSync

Batch = Dict[str, torch.Tensor]


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
                    sync_bn: bool = False, zero: str = "none", overlap: str = "none",
                    bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB,
                    wus_gather: str = "eager", seed: int = 0):
    """``step(batch, lr) -> metrics`` (device scalars: ``loss``, ``acc1``,
    ``acc5`` in percent; ``nonfinite`` under ``guard_nonfinite``;
    ``grad_norm`` and ``param_norm`` under ``log_norms``).  ``group``: the
    process group of data parallelism (None: one device), with the GSPMD
    twin or, under ``explicit_collectives``, the explicit one, whose
    BatchNorm ``sync_bn`` makes global.

    ``grad_compress``: ``none | bf16 | int8 | fp8``, the gradient wire (the
    GSPMD twin's is an emulation of its numerics).  ``zero="wus"``:
    weight-update sharding, this rank's momentum 1/N of the whole.
    ``overlap="bucketed"`` (explicit step only): ~``bucket_mb``-MiB buckets,
    each collective started as its gradients are ready.
    ``wus_gather="deferred"`` (``wus`` and bucketed, f32 or bf16 wire):
    the step's delta is gathered at the head of the next step, so the
    parameters lag one step until ``step.comm.materialize()``.  The
    explicit step's gradient sync and the stack's state ride on
    ``step.comm`` (a ``GradSync``; None on the GSPMD twin without a
    quantized mode or ``wus``), which checkpoints save and restore.
    ``seed`` and ``step.count`` key the dropout masks."""
    mode, cast_dtype = qcomm.resolve_mode(grad_compress)
    zero_mode = zero_lib.resolve_zero(zero)
    overlap_mode = overlap_lib.resolve_overlap(overlap)
    if overlap_mode == "bucketed" and not explicit_collectives:
        raise ValueError(
            "overlap='bucketed' schedules hand-written collectives and "
            "requires explicit_collectives=True (under GSPMD, XLA owns "
            "collective placement — there is nothing to bucket)")
    if wus_gather not in ("eager", "deferred"):
        raise ValueError(
            f"wus_gather must be 'eager' or 'deferred', got {wus_gather!r}")
    if wus_gather == "deferred":
        if zero_mode != "wus" or overlap_mode != "bucketed":
            raise ValueError(
                "wus_gather='deferred' is the double-buffered ZeRO-WUS "
                "delta gather — it requires zero='wus' and "
                "overlap='bucketed'")
        if mode in qcomm.QUANTIZED_MODES:
            raise ValueError(
                "wus_gather='deferred' supports the f32/bf16 delta wire "
                "only: the quantized gather's error feedback is step-order"
                "-dependent and cannot be staged across steps")
    if zero_mode == "wus" and not isinstance(optimizer, torch.optim.SGD):
        raise ValueError(
            "zero='wus' implements the torch-parity SGD update on 1/N "
            "shards; an optax tx cannot be chunked — drop one of them")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mode != "none" and not explicit_collectives:
        warnings.warn(
            f"make_train_step: grad_compress={mode!r} under GSPMD is a "
            "NUMERICS emulation only — the gradient all-reduce moves f32, "
            "so the quantize/cast rounds already-synced values and does not "
            "compress the collective wire format. Use "
            "explicit_collectives=True for true compressed-wire gradient "
            "sync (the Horovod-compression analogue).",
            stacklevel=2,
        )
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = list(model.buffers())
    stats = [b for b in buffers if b.is_floating_point()]
    wus = zero_mode == "wus"
    comm = None
    if explicit_collectives or mode in qcomm.QUANTIZED_MODES or wus:
        comm = GradSync(model, group, mode=mode, cast_dtype=cast_dtype,
                        explicit=explicit_collectives, zero=zero_mode, overlap=overlap_mode,
                        bucket_mb=bucket_mb, wus_gather=wus_gather)
    # The GSPMD twin is DDP, but under wus its all-reduce gives way to the
    # reduce-scatter of GradSync: no DDP, the same global-batch BatchNorm.
    gspmd = group is not None and not explicit_collectives
    net = data_parallel(model, group) if gspmd and not wus else model
    if (gspmd and wus) or (sync_bn and explicit_collectives and group is not None):
        model.set_bn_group(group)
    hyper = optimizer.param_groups[0]
    drops = dropout_layers(model)
    ranks = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))

    def momentum_buffers() -> List[torch.Tensor]:
        return [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]

    def step(batch: Batch, lr: float) -> Dict[str, torch.Tensor]:
        if guard_nonfinite:
            old_buffers = [b.clone() for b in buffers]
            old_params = [p.detach().clone() for p in params]
            old_moms = [torch.zeros_like(p) if m is None else m.clone()
                        for p, m in zip(params, momentum_buffers())]
            old_comm = [t.clone() for t in comm.state_tensors()] if comm is not None else []
        if comm is not None and comm.deferred:
            comm.drain()  # the previous step's delta, at the head of this one
        net.train()
        optimizer.zero_grad(set_to_none=True)
        b = batch["images"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch dimension {b} is not divisible by accum_steps "
                             f"{accum_steps}")
        loss_sum = c1 = c5 = count = 0.0
        for i in range(accum_steps):
            # Strided split: microbatch i = samples [i::accum_steps].
            mb = batch if accum_steps == 1 else {k: v[i::accum_steps] for k, v in batch.items()}
            # DDP reduces once, after the last microbatch's backward; the
            # bucket hooks fire during that one only.
            defer = net is not model and i < accum_steps - 1
            if drops:
                set_dropout_key(drops, DropoutKey(seed, step.count, i, *ranks,
                                                  per_rank=explicit_collectives))
            if comm is not None:
                comm.arm(i == accum_steps - 1)
            with net.no_sync() if defer else contextlib.nullcontext():
                mb_loss, mb_c1, mb_c5, mb_count = forward_and_sums(net, mb)
                mb_loss.backward()  # .grad holds the sum over microbatches
            loss_sum = loss_sum + mb_loss.detach()
            c1, c5, count = c1 + mb_c1, c5 + mb_c5, count + mb_count
        step.count += 1
        if group is not None:
            sums = torch.stack([loss_sum, c1, c5, count]).float()
            dist.all_reduce(sums, group=group)
            loss_sum, c1, c5, count = sums
        want_norm = log_norms or guard_nonfinite
        gnorm = None
        if not explicit_collectives:
            count = count.clamp_min(1.0)
        if wus:
            # The JAX local_step's reduce-scatter, chunked SGD and gather
            # (GSPMD: the same semantics, the count clamped).
            gnorm = comm.wus_step(count, lr, hyper["momentum"], hyper["weight_decay"],
                                  want_norm)
        elif explicit_collectives:
            # The JAX local_step: the local weighted sums on the wire, the
            # global count divides them in f32 (no clamp, as there).
            comm.sync_explicit(count)
        else:
            for p in params:
                p.grad.div_(count)
                if cast_dtype is not None:
                    p.grad = p.grad.to(cast_dtype).float()
            if comm is not None:
                comm.emulate_grads()
        if want_norm and gnorm is None:
            gnorm = _l2_norm(p.grad for p in params)
        metrics = {"loss": loss_sum / count, "acc1": c1 * 100.0 / count,
                   "acc5": c5 * 100.0 / count}
        if not wus:
            for pg in optimizer.param_groups:
                pg["lr"] = lr
            optimizer.step()
        if explicit_collectives and group is not None and stats:
            # BN running statistics: the ranks' EMAs averaged (JAX pmean).
            world = dist.get_world_size(group)
            with torch.no_grad():
                summed = qcomm.sum_finish(qcomm.sum_start(stats, group),
                                          [b_.shape for b_ in stats])
                for b_, avg in zip(stats, summed):
                    b_.copy_(avg / world)
        if guard_nonfinite:
            bad = ~(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            with torch.no_grad():
                for new, old in zip([p.data for p in params] + momentum_buffers() + buffers,
                                    old_params + old_moms + old_buffers):
                    if new is not None:
                        new.copy_(torch.where(bad, old, new))
                if comm is not None:
                    comm.set_state_tensors([torch.where(bad, old, new) for new, old in
                                            zip(comm.state_tensors(), old_comm)])
            metrics["nonfinite"] = bad.float()
        if log_norms:
            metrics["grad_norm"] = gnorm
            with torch.no_grad():
                metrics["param_norm"] = _l2_norm(params)
        return metrics

    step.comm = comm
    step.count = 0
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
