"""Epoch loop of the image recipes, the port of
``pytorch_distributed_tpu/train/trainer.py`` reduced to its single-device
synthetic path: data, model, SGD, ``train_epoch`` with the LR schedule and
the progress meters, ``validate`` with exact padded sums, ``fit`` with the
best top-1 and the epoch CSV.

Not ported yet, each exiting from ``train/config.py`` with its ROADMAP item:
ImageFolder data (A17), multi-process data parallelism (A18), checkpoints,
resume and ``--pretrained`` (A16), the divergence rollback policy, elastic
membership and the preemption guard (A11), and the observability layer
(A12).  ``--nan-guard`` is ported as the in-step gate.
"""

from __future__ import annotations

import time

import torch

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DeviceFeeder,
    DistributedShardSampler,
    SyntheticImageDataset,
)
from pytorch_distributed_tpu_torch.train.config import Config
from pytorch_distributed_tpu_torch.train.lr import cosine_lr, step_decay_lr
from pytorch_distributed_tpu_torch.train.meters import AverageMeter, ProgressMeter, StepMeters
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_eval_step, make_train_step
from pytorch_distributed_tpu_torch.utils.csvlog import EpochCSVLogger
from pytorch_distributed_tpu_torch.utils.device import resolve_device


class Trainer:
    """Image training on one device.  ``step_times`` and ``losses`` collect
    every train step's host seconds (as the meter measures them) and its
    loss (a device scalar); ``eval_history`` holds ``(loss, acc1, acc5)`` per
    ``validate``."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.seed = cfg.seed if cfg.seed is not None else 0
        self._build_data()
        dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
        self.model = models.create_model(cfg.arch, num_classes=cfg.num_classes, dtype=dtype,
                                         stem=cfg.stem, fused_convbn=cfg.fused_convbn,
                                         device=self.device)
        self.model.init_weights(torch.Generator(device=self.device).manual_seed(self.seed))
        self.optimizer = sgd(self.model.parameters(), cfg.lr, cfg.momentum, cfg.weight_decay)
        if cfg.accum_steps < 1 or cfg.batch_size % cfg.accum_steps:
            raise ValueError(f"batch {cfg.batch_size} / --accum-steps {cfg.accum_steps} "
                             "must be a whole number of samples")
        self.train_step = make_train_step(self.model, self.optimizer,
                                          accum_steps=cfg.accum_steps,
                                          guard_nonfinite=cfg.nan_guard)
        self.eval_step = make_eval_step(self.model)
        self.feeder = DeviceFeeder(self.device)
        self.csv = EpochCSVLogger(cfg.epoch_csv)
        self.best_acc1 = 0.0
        self.step_times: list = []
        self.losses: list = []
        self.eval_history: list = []

    def _build_data(self) -> None:
        cfg = self.cfg
        self.train_set = SyntheticImageDataset(length=cfg.synthetic_length,
                                               num_classes=cfg.num_classes,
                                               image_size=cfg.image_size, seed=self.seed)
        self.val_set = SyntheticImageDataset(length=max(cfg.synthetic_length // 10, 2),
                                             num_classes=cfg.num_classes,
                                             image_size=cfg.image_size, seed=self.seed + 1)
        self.train_sampler = DistributedShardSampler(len(self.train_set), 1, 0, shuffle=True,
                                                     seed=self.seed)
        self.val_sampler = DistributedShardSampler(len(self.val_set), 1, 0, shuffle=False,
                                                   seed=self.seed)
        # drop_last on train: a zero-padded partial batch would pollute that
        # batch's BatchNorm statistics; eval pads and masks, so it is exact.
        self.train_loader = DataLoader(self.train_set, cfg.batch_size,
                                       sampler=self.train_sampler, num_workers=cfg.workers,
                                       drop_last=True)
        self.val_loader = DataLoader(self.val_set, cfg.batch_size, sampler=self.val_sampler,
                                     num_workers=cfg.workers)

    def epoch_lr(self, epoch: int) -> float:
        cfg = self.cfg
        if cfg.lr_schedule == "cosine":
            return cosine_lr(cfg.lr, epoch, cfg.epochs, warmup_epochs=cfg.lr_warmup_epochs)
        if cfg.lr_schedule == "step":
            return step_decay_lr(cfg.lr, epoch)
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}: expected 'step' or "
                         "'cosine'")

    def train_epoch(self, epoch: int) -> int:
        """One epoch; returns the number of steps taken."""
        lr = self.epoch_lr(epoch)
        meters = StepMeters(len(self.train_loader),
                            [("loss", "Loss", ":.4e"), ("acc1", "Acc@1", ":6.2f"),
                             ("acc5", "Acc@5", ":6.2f")], prefix=f"Epoch: [{epoch}]")
        self.train_loader.set_epoch(epoch)
        self.val_sampler.set_epoch(epoch)
        meters.restart_clock()
        steps = 0
        for i, batch in enumerate(self.feeder(iter(self.train_loader))):
            metrics = self.train_step(batch, lr)
            self.step_times.append(meters.update(metrics, self.cfg.batch_size))
            self.losses.append(metrics["loss"])
            meters.maybe_display(i, self.cfg.print_freq)
            steps += 1
        return steps

    @torch.no_grad()
    def validate(self) -> float:
        """Top-1 over the validation set (exact: padded slots carry weight
        0); prints the reference's summary line."""
        batch_time = AverageMeter("Time", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        top5 = AverageMeter("Acc@5", ":6.2f")
        progress = ProgressMeter(len(self.val_loader), [batch_time, losses, top1, top5],
                                 prefix="Test: ")
        totals = {"loss_sum": 0.0, "correct1": 0.0, "correct5": 0.0, "count": 0.0}
        end = time.time()
        for i, batch in enumerate(self.feeder(iter(self.val_loader))):
            sums = {k: float(v) for k, v in self.eval_step(batch).items()}
            c = sums["count"]
            if c > 0:
                losses.update(sums["loss_sum"] / c, int(c))
                top1.update(sums["correct1"] * 100.0 / c, int(c))
                top5.update(sums["correct5"] * 100.0 / c, int(c))
            for k in totals:
                totals[k] += sums[k]
            batch_time.update(time.time() - end)
            end = time.time()
            if i % self.cfg.print_freq == 0:
                progress.display(i)
        count = max(totals["count"], 1.0)
        acc1 = totals["correct1"] * 100.0 / count
        acc5 = totals["correct5"] * 100.0 / count
        self.eval_history.append((totals["loss_sum"] / count, acc1, acc5))
        print(f" * Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}", flush=True)
        return acc1

    def fit(self) -> float:
        """Train ``--start-epoch`` .. ``--epochs``, validating after each
        epoch; returns the best top-1 (or only validates under
        ``--evaluate``)."""
        cfg = self.cfg
        if cfg.evaluate:
            return self.validate()
        for epoch in range(cfg.start_epoch, cfg.epochs):
            self.csv.epoch_start()
            self.train_epoch(epoch)
            acc1 = self.validate()
            print(f"Epoch {epoch} took {self.csv.epoch_end():.1f}s", flush=True)
            self.best_acc1 = max(acc1, self.best_acc1)
        return self.best_acc1
