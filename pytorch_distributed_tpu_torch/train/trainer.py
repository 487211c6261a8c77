"""Epoch loop of the image recipes, the port of
``pytorch_distributed_tpu/train/trainer.py``, on one device per process: data
(synthetic, or an ImageFolder tree through the ``--wire`` pipelines), model,
SGD, ``train_epoch`` with the LR schedule and the progress meters,
``validate`` with exact padded sums, ``fit`` with the best top-1 and the
epoch CSV, and checkpoints (``train/checkpoint.py``, the
JAX package's format): ``--pretrained``, ``--resume`` to the exact step,
``--save-steps`` inside an epoch and a save at each epoch's end, with
``model_best`` on a new best top-1.

Data parallelism (``ctx`` from ``parallel.initialize``): the device is the
local rank's, each rank loads ``batch_size // world`` samples of its
sampler shard, the train step is the GSPMD twin (DDP, global-batch
BatchNorm) or the explicit one, eval sums are all-reduced; rank 0 alone
prints, writes the epoch CSV and saves checkpoints while the others wait
at a barrier; every rank resumes from the same file.

Any arch of the image zoo (``models.model_names()``), built at
``--image-size`` (which fixes a ViT's position grid).  ``--stem`` and
``--fused-convbn`` are refused on a non-ResNet, as in the JAX trainer.
``--sync-bn`` gives the explicit step (``horovod_distributed``) the
global-batch BatchNorm the GSPMD twin always has; there, and without a
process group, it is the JAX package's no-op.  As in the JAX trainer, the
explicit step refuses it with ``--fused-convbn``, on an arch without
BatchNorm and on a plain VGG.  Dropout masks are keyed by ``--seed`` and
the global step (``train/steps.py``), so ``--resume`` draws the masks an
uninterrupted run would.

The gradient-communication stack (``--grad-compress int8|fp8``, ``--zero
wus``, ``--overlap bucketed``, ``--bucket-mb``) goes to the train step,
whose ``GradSync`` holds this rank's error-feedback residual and, under
``wus``, its 1/N of the momentum; checkpoints gather and restore them in
the JAX layout (every rank takes part, rank 0 writes), and a deferred
delta gather is applied before every eval and checkpoint.

The metrics stream (``train/observe.py``), wired as in the JAX trainer:
one ``MetricsLogger`` hub with the epoch CSV as its epoch sink, a record per
step under ``--metrics-jsonl`` (with the step's gradient and parameter
norms), ``--hb-dir`` beats per process, ``--mfu`` from the arch's analytic
cost over the global batch and the world, ``--goodput`` (its summary at the
end of ``fit``), ``--step-attr`` windows (``data_wait`` around the batch,
``device`` around the step and ``torch.cuda.synchronize()``, ``host_sync``
around the meters and the record), the ``--telemetry-csv`` sampler as a
sink of the hub, and ``--profile-dir`` traces windowed per epoch and step
(``--profile-epochs``, ``--profile-steps``).

The death paths and the live plane, wired as in the JAX trainer: ``fit``
installs a ``PreemptionGuard`` on ``--preempt-signals`` (SIGTERM by
default; main thread only) unless one is passed, polls the flag agreed
over the ranks every ``--print-freq`` steps and at each epoch's end, and on
a stop writes a step-granular checkpoint, logs a ``preempt`` event and
stops; ``--flight-rec`` keeps the ring (each step's window and collective
region, every ft_event, each checkpoint), dumps it on the signal (then
chains to the guard), on any exception (re-raised) and from the
``--hang-timeout`` watchdog; ``--metrics-port`` serves the latest record
and ``--alerts`` books firings as ``alert`` events.  ``chaos=`` takes the
``ft/chaos.py`` hooks where the JAX trainer calls them.

The divergence guard (``--nan-guard``, ``--ft-rollback-k``,
``--ft-check-every``, ``--ft-lr-backoff``; ``ft/divergence.py``), as in the
JAX trainer: the step gates a non-finite update on the device, every
flagged step is a ``skip`` event, and K consecutive ones restore the
last-good host snapshot (taken at the start and at every checkpoint) with
the LR scaled by the backoff, which checkpoints carry as ``lr_scale``.

Not ported yet, each exiting from ``train/config.py`` with its ROADMAP item:
elastic membership (A11), and the ledgers and the recompile watch (A12).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DeviceFeeder,
    DistributedShardSampler,
    ImageFolder,
    SyntheticImageDataset,
)
from pytorch_distributed_tpu_torch.data.native import jpeg_native_available
from pytorch_distributed_tpu_torch.data.native.binding import searched
from pytorch_distributed_tpu_torch.ft.divergence import DivergenceGuard, StateKeeper
from pytorch_distributed_tpu_torch.data.transforms import (
    eval_transform,
    eval_transform_u8,
    train_transform,
    train_transform_u8,
)
from pytorch_distributed_tpu_torch.obs.flops import image_step_cost
from pytorch_distributed_tpu_torch.obs.trace import ProfileWindow, scope
from pytorch_distributed_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pytorch_distributed_tpu_torch.train.config import Config
from pytorch_distributed_tpu_torch.train.lr import cosine_lr, step_decay_lr
from pytorch_distributed_tpu_torch.train.meters import AverageMeter, ProgressMeter, StepMeters
from pytorch_distributed_tpu_torch.train.observe import TrainObs
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_eval_step, make_train_step
from pytorch_distributed_tpu_torch.parallel import DistContext, device_for
from pytorch_distributed_tpu_torch.utils.csvlog import EpochCSVLogger
from pytorch_distributed_tpu_torch.utils.preempt import (
    PreemptionAgreement,
    PreemptionGuard,
    parse_signals,
)
from pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySampler


class Trainer:
    """Image training, one device per process.  ``step_times`` and ``losses`` collect
    every train step's host seconds (as the meter measures them) and its
    loss (a device scalar); ``eval_history`` holds ``(loss, acc1, acc5)`` per
    ``validate``; ``global_step`` counts the train steps taken, restored by
    ``--resume``.  ``preempt``: an installed ``PreemptionGuard`` (else
    ``fit`` installs one on ``--preempt-signals``); ``chaos``: an
    ``ft/chaos.py`` injector; ``preempted`` says whether ``fit`` stopped on
    one."""

    def __init__(self, cfg: Config, ctx: Optional[DistContext] = None,
                 explicit_collectives: bool = False, preempt=None, chaos=None):
        self.cfg = cfg
        self.preempt = preempt
        self.chaos = chaos
        self.preempted = False
        self._agree = None
        self.ctx = ctx or DistContext(0, 1, None)
        self.explicit_collectives = explicit_collectives
        self.primary = self.ctx.is_primary
        self.device = device_for(self.ctx, cfg.device)
        self.seed = cfg.seed if cfg.seed is not None else 0
        # The global batch divided across processes (the JAX trainer's rule).
        cfg.nprocs = self.ctx.process_count
        if cfg.batch_size % cfg.nprocs:
            raise ValueError(f"global batch {cfg.batch_size} not divisible by {cfg.nprocs} "
                             "processes")
        self.local_batch = cfg.batch_size // cfg.nprocs
        self._build_data()
        dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
        # --stem / --fused-convbn are ResNet-family knobs, forwarded only
        # when set (the JAX trainer's rule and refusal).
        extra = {} if cfg.stem == "conv7" else {"stem": cfg.stem}
        if cfg.fused_convbn:
            extra["fused_convbn"] = True
        if extra and not models.is_resnet(cfg.arch):
            raise ValueError(f"--stem/--fused-convbn only apply to the ResNet family; "
                             f"arch {cfg.arch!r} has no such variant")
        if cfg.sync_bn and explicit_collectives:
            if cfg.fused_convbn:
                # The JAX trainer's refusal, kept although K4/K5 here would
                # take the reduced vectors.
                raise ValueError(
                    "--sync-bn and --fused-convbn are mutually exclusive: "
                    "the fused conv+BN backward has no cross-replica "
                    "statistics variant; drop one of the flags")
            models.check_sync_bn(cfg.arch)  # no BatchNorm, or a plain VGG
        self.model = models.create_model(cfg.arch, num_classes=cfg.num_classes, dtype=dtype,
                                         image_size=cfg.image_size, device=self.device,
                                         **extra)
        self.model.init_weights(torch.Generator(device=self.device).manual_seed(self.seed))
        self.optimizer = sgd(self.model.parameters(), cfg.lr, cfg.momentum, cfg.weight_decay)
        if cfg.accum_steps < 1 or self.local_batch % cfg.accum_steps:
            raise ValueError(f"batch {self.local_batch} per process / --accum-steps "
                             f"{cfg.accum_steps} must be a whole number of samples")
        group = self.ctx.group
        self.train_step = make_train_step(self.model, self.optimizer,
                                          accum_steps=cfg.accum_steps,
                                          log_norms=bool(cfg.metrics_jsonl),
                                          guard_nonfinite=cfg.nan_guard, group=group,
                                          explicit_collectives=explicit_collectives,
                                          grad_compress=cfg.grad_compress,
                                          sync_bn=cfg.sync_bn, zero=cfg.zero or "none",
                                          overlap=cfg.overlap, bucket_mb=cfg.bucket_mb,
                                          seed=self.seed)
        self.comm = self.train_step.comm
        self.eval_step = make_eval_step(self.model, group)
        self.feeder = DeviceFeeder(self.device)
        self.csv = EpochCSVLogger(cfg.epoch_csv if self.primary else None)
        self.ro = TrainObs(self.device, self.ctx.process_index, self.ctx.process_count,
                           metrics_jsonl=cfg.metrics_jsonl, hb_dir=cfg.hb_dir,
                           hb_interval_s=cfg.hb_interval_s, mfu=cfg.mfu, goodput=cfg.goodput,
                           step_attr=cfg.step_attr, hb_world=self.ctx.process_count,
                           cost=lambda: image_step_cost(cfg.arch, cfg.batch_size,
                                                        cfg.image_size, cfg.num_classes),
                           flight_rec=cfg.flight_rec, hang_timeout=cfg.hang_timeout,
                           metrics_port=cfg.metrics_port, alerts=cfg.alerts)
        self.obs = self.ro.obs     # the hub: the epoch CSV is its epoch sink
        self.obs.register(self.csv)
        # The divergence guard and the last-good snapshot (ft/divergence.py):
        # the policy over the step's in-step nonfinite flag.
        self.ft_guard = self._keeper = None
        if cfg.nan_guard:
            self.ft_guard = DivergenceGuard(rollback_k=cfg.ft_rollback_k,
                                            check_every=cfg.ft_check_every,
                                            lr_backoff=cfg.ft_lr_backoff, obs=self.obs)
            self._keeper = StateKeeper()
        self.step_times: list = []
        self.losses: list = []
        self.eval_history: list = []
        if cfg.pretrained:
            self._load_pretrained()
        self.best_acc1 = 0.0
        self._resume_step = 0    # step-in-epoch offset for the first epoch
        self.global_step = 0
        if cfg.resume:
            self._resume(cfg.resume)

    def _resume(self, path: str) -> None:
        """Restore weights, momentum, BN statistics and the ``ft`` record; a
        mid-epoch file reruns the same epoch from its step, an epoch-boundary
        file starts the next epoch."""
        cfg = self.cfg
        _, meta = load_checkpoint(path, self.model, self.optimizer, comm=self.comm)
        self.best_acc1 = float(meta["best_acc1"])
        ft = meta["ft"]
        self._resume_step = int(ft["step"])
        self.global_step = int(ft["global_step"])
        if self.ft_guard is not None:
            self.ft_guard.lr_scale = float(ft["lr_scale"])
        self.train_step.count = self.global_step  # the dropout masks' step
        if self._resume_step > 0 and int(ft["sampler_seed"]) != self.seed:
            warnings.warn(
                f"resuming mid-epoch with --seed {self.seed} but the checkpoint's sampler "
                f"ran with seed {int(ft['sampler_seed'])}: the shuffle permutation differs, "
                "so the resumed epoch will not be sample-exact", stacklevel=2)
        if cfg.start_epoch == 0:
            cfg.start_epoch = int(meta["epoch"]) + (0 if self._resume_step > 0 else 1)
        self.log(f"=> resumed {meta['arch']} from '{path}' (epoch {meta['epoch']}, step "
              f"{self._resume_step}, best_acc1 {self.best_acc1:.3f})")

    def _load_pretrained(self) -> None:
        """``--pretrained``: weights from a local directory,
        ``$PTD_TPU_PRETRAINED_DIR/<arch>.msgpack`` (default ``pretrained/``),
        any checkpoint either package saved for the same arch."""
        d = os.environ.get("PTD_TPU_PRETRAINED_DIR", "pretrained")
        path = os.path.join(d, f"{self.cfg.arch}.msgpack")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"--pretrained: no weights at '{path}'; set PTD_TPU_PRETRAINED_DIR to a "
                f"directory containing {self.cfg.arch}.msgpack (a checkpoint saved by this "
                "framework)")
        load_checkpoint(path, self.model, self.optimizer, comm=self.comm)
        self.log(f"=> using pre-trained model '{self.cfg.arch}' from '{path}'")

    def log(self, line: str) -> None:
        """Print on rank 0 only."""
        if self.primary:
            print(line, flush=True)

    def _ft_record(self, epoch: int, step_in_epoch: int) -> dict:
        return {"step": int(step_in_epoch), "global_step": int(self.global_step),
                "sampler_seed": int(self.train_sampler.seed), "sampler_epoch": int(epoch),
                "lr_scale": self.ft_guard.lr_scale if self.ft_guard is not None else 1.0}

    def _snapshot(self) -> None:
        """Refresh the last-good snapshot (every rank, at the same step)."""
        self._keeper.update(self.model, self.optimizer, self.global_step, comm=self.comm,
                            step_fn=self.train_step)

    def _rollback(self, epoch: int, step_in_epoch: int) -> float:
        """Divergence recovery: restore the last-good snapshot in place and
        back off the LR scale (the ``rollback`` ft_event; the flight ring is
        dumped as ``rollback``).  Returns the new scale."""
        restored = None
        if self._keeper is not None and self._keeper.has_snapshot:
            self._keeper.restore(self.model, self.optimizer, comm=self.comm,
                                 step_fn=self.train_step)
            restored = self._keeper.step
        scale = self.ft_guard.note_rollback(self.global_step, restored)
        self.log(f"=> divergence rollback at epoch {epoch} step {step_in_epoch}: restored "
                 f"state from global step {restored}, lr scale now {scale:g}")
        if self.ro.flight is not None:
            self.ro.flight.dump("rollback")
        return scale

    def save(self, epoch: int, step_in_epoch: int = 0, is_best: bool = False
             ) -> Optional[str]:
        """Checkpoint to ``--checkpoint-dir``: at an epoch's end
        (``step_in_epoch`` 0) or after ``step_in_epoch`` steps of ``epoch``.
        Every rank gathers the gradient-communication state first (a
        collective); rank 0 writes (and returns the path); every rank
        waits for it."""
        cfg = self.cfg
        path = None
        trees = {}
        if self.comm is not None:
            self.comm.materialize()
            trees = self.comm.checkpoint_trees()
        if self.primary:
            path = save_checkpoint(cfg.checkpoint_dir, self.model, self.optimizer,
                                   self.global_step, epoch, cfg.arch, self.best_acc1, is_best,
                                   ft=self._ft_record(epoch, step_in_epoch), **trees)
        if self.ctx.group is not None:
            dist.barrier(group=self.ctx.group)
        self.ro.checkpoint(self.global_step, epoch=epoch, step_in_epoch=step_in_epoch)
        if self._keeper is not None:
            self._snapshot()
        return path

    def _preempt_agreed(self) -> bool:
        """Did any rank's guard flag?  Every rank calls this at the same
        step (a collective over the process group)."""
        if self._agree is None:
            self._agree = PreemptionAgreement(self.ctx.group, self.device)
        return self._agree(self.preempt.triggered)

    def _build_data(self) -> None:
        """Datasets, samplers and loaders, as the JAX trainer builds them:
        synthetic data (f32), or the ImageFolder tree ``--data`` with
        ``train/`` and ``val/`` (``num_classes`` from the tree) through the
        ``--wire`` pipeline and ``--worker-type`` workers."""
        cfg = self.cfg
        if cfg.synthetic:
            self.train_set = SyntheticImageDataset(length=cfg.synthetic_length,
                                                   num_classes=cfg.num_classes,
                                                   image_size=cfg.image_size, seed=self.seed)
            self.val_set = SyntheticImageDataset(length=max(cfg.synthetic_length // 10,
                                                            2 * self.ctx.process_count),
                                                 num_classes=cfg.num_classes,
                                                 image_size=cfg.image_size, seed=self.seed + 1)
        elif cfg.wire == "native":
            # C++ JPEG decode + crop/resize per batch, the flip on the host,
            # uint8 to the card, normalized there.
            if not jpeg_native_available():
                raise RuntimeError(
                    "--wire native needs the C++ data plane built against libjpeg: no "
                    f"libjpeg.so.62 on this host (searched: {searched('jpeg')}); use --wire u8 "
                    "or u8host on this host")
            self.train_set = ImageFolder(f"{cfg.data}/train", native_decode=True,
                                         image_size=cfg.image_size, native_augment=True)
            self.val_set = ImageFolder(f"{cfg.data}/val", native_decode=True,
                                       image_size=cfg.image_size, native_augment=False)
            cfg.num_classes = len(self.train_set.classes)
        else:
            if cfg.wire == "f32":
                ttf, vtf = train_transform(cfg.image_size), eval_transform(cfg.image_size)
            else:
                ttf = train_transform_u8(cfg.image_size)
                vtf = eval_transform_u8(cfg.image_size)
            self.train_set = ImageFolder(f"{cfg.data}/train", transform=ttf)
            self.val_set = ImageFolder(f"{cfg.data}/val", transform=vtf)
            cfg.num_classes = len(self.train_set.classes)
        world, rank = self.ctx.process_count, self.ctx.process_index
        self.train_sampler = DistributedShardSampler(len(self.train_set), world, rank,
                                                     shuffle=True, seed=self.seed)
        self.val_sampler = DistributedShardSampler(len(self.val_set), world, rank,
                                                   shuffle=False, seed=self.seed)
        # drop_last on train: a zero-padded partial batch would pollute that
        # batch's BatchNorm statistics; eval pads and masks, so it is exact.
        # Synthetic datasets emit f32; the wire modes apply to ImageFolder.
        batch_mode = "f32" if cfg.synthetic else {
            "f32": "f32", "u8host": "u8_host", "u8": "u8_wire", "native": "u8_wire"}[cfg.wire]
        common = dict(num_workers=cfg.workers, seed=self.seed, batch_mode=batch_mode,
                      worker_type=cfg.worker_type)
        self.train_loader = DataLoader(self.train_set, self.local_batch,
                                       sampler=self.train_sampler, drop_last=True,
                                       random_flip=batch_mode != "f32", **common)
        self.val_loader = DataLoader(self.val_set, self.local_batch, sampler=self.val_sampler,
                                     **common)

    def epoch_lr(self, epoch: int) -> float:
        cfg = self.cfg
        if cfg.lr_schedule == "cosine":
            return cosine_lr(cfg.lr, epoch, cfg.epochs, warmup_epochs=cfg.lr_warmup_epochs)
        if cfg.lr_schedule == "step":
            return step_decay_lr(cfg.lr, epoch)
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}: expected 'step' or "
                         "'cosine'")

    def train_epoch(self, epoch: int, start_step: int = 0,
                    stop_after: Optional[int] = None,
                    profiler: Optional[ProfileWindow] = None) -> int:
        """Steps ``start_step`` .. the end of ``epoch`` (or until
        ``stop_after`` steps of it are complete, or an agreed preemption,
        which sets ``preempted``), checkpointing every ``--save-steps``;
        returns the number of steps of the epoch complete.  ``profiler``
        (``fit``'s) opens and closes its step window."""
        lr = self.epoch_lr(epoch)
        guard = self.ft_guard
        scale = guard.lr_scale if guard is not None else 1.0
        meters = StepMeters(len(self.train_loader),
                            [("loss", "Loss", ":.4e"), ("acc1", "Acc@1", ":6.2f"),
                             ("acc5", "Acc@5", ":6.2f")], prefix=f"Epoch: [{epoch}]")
        self.train_loader.set_epoch(epoch)
        self.val_sampler.set_epoch(epoch)
        epoch_len, save_steps = len(self.train_loader), self.cfg.save_steps
        completed = start_step
        if stop_after is not None and stop_after <= start_step:
            return completed
        if self._keeper is not None and not self._keeper.has_snapshot:
            self._snapshot()   # the initial last-good state (every rank)
        meters.restart_clock()
        batches = self.feeder(self.train_loader.iter_batches(start_step))
        ro, n, chaos = self.ro, self.cfg.batch_size, self.chaos
        for i in range(start_step, epoch_len):
            if profiler is not None:
                profiler.step_begin(epoch, i)
            # At print_freq cadence: the agreement is a collective every
            # rank runs at the same step, off the per-step path.
            if (self.preempt is not None and i % self.cfg.print_freq == 0
                    and self._preempt_agreed()):
                self.preempted = True
                batches.close()
                return completed
            if chaos is not None:
                chaos.on_step(self, i)
            # data_wait holds the batch and the chaos batch hook.
            with ro.data_wait():
                batch = next(batches, None)
                if batch is not None and chaos is not None:
                    batch = chaos.on_batch(i, batch)
            if batch is None:
                break
            ro.step_begin(self.global_step)
            if chaos is not None:
                chaos.on_collective(self, self.global_step)
            with scope("train_step"), ro.device_window():
                metrics = self.train_step(batch, lr * scale)
            ro.step_end(self.global_step)
            with ro.host_sync():
                dt = meters.update(metrics, n)
            self.step_times.append(dt)
            self.losses.append(metrics["loss"])
            ro.log_step(self.global_step, dt, n, lr, dict(metrics), {"epoch": epoch})
            if self.primary:
                meters.maybe_display(i, self.cfg.print_freq)
            self.global_step += 1
            completed = i + 1
            at_save = save_steps > 0 and completed % save_steps == 0 and completed < epoch_len
            if guard is not None:
                # The flags buffer unconverted and drain every
                # --ft-check-every steps, and at a save boundary, so a
                # snapshot never races an undetected divergence.  The flag
                # is reduced in the step: every rank drains the same verdict.
                rollback = guard.observe(self.global_step - 1, metrics.get("nonfinite"))
                if at_save:
                    rollback = guard.drain() or rollback
                if rollback:
                    scale = self._rollback(epoch, i)
                # A flagged streak means the state is suspect: no snapshot or
                # checkpoint of it.
                at_save = at_save and guard.consecutive == 0
            if at_save:
                self.save(epoch, completed)
                meters.restart_clock()  # exclude checkpoint I/O from the meter
            if completed == stop_after:
                break
        if guard is not None and guard.drain():
            # Flags buffered past the last drain resolve before the epoch's
            # checkpoint can capture a diverged state.
            self._rollback(epoch, completed)
        return completed

    @torch.no_grad()
    def validate(self) -> float:
        """Top-1 over the validation set (exact: padded slots carry weight
        0); prints the reference's summary line."""
        if self.comm is not None:
            self.comm.materialize()
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
            if self.primary and i % self.cfg.print_freq == 0:
                progress.display(i)
        count = max(totals["count"], 1.0)
        acc1 = totals["correct1"] * 100.0 / count
        acc5 = totals["correct5"] * 100.0 / count
        self.eval_history.append((totals["loss_sum"] / count, acc1, acc5))
        self.log(f" * Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
        return acc1

    def fit(self) -> float:
        """Train ``--start-epoch`` .. ``--epochs`` (the first from the resumed
        step), validating and checkpointing after each epoch; returns the
        best top-1 (or only validates under ``--evaluate``).  Drives the
        profiler window, the telemetry sampler, the preemption guard (its
        own on ``--preempt-signals`` unless one was passed; main thread
        only), the flight recorder's death paths and, at the end, the last
        heartbeat and the goodput summary."""
        cfg = self.cfg
        if cfg.evaluate:
            return self.validate()
        if cfg.telemetry_csv:
            # Registered on the hub, which stops it at the end.
            self.obs.register(TelemetrySampler(cfg.telemetry_csv, device=self.device))
        signals = parse_signals(cfg.preempt_signals)
        self.preempted = False
        installed = (self.preempt is None
                     and threading.current_thread() is threading.main_thread())
        if installed:
            self.preempt = PreemptionGuard(signals=signals).install()
        # After the guard: the signal dumps the ring first, then chains to it.
        self.ro.arm(signals)
        profiler = ProfileWindow(cfg.profile_dir, epochs=cfg.profile_epochs,
                                 steps=cfg.profile_steps, start_epoch=cfg.start_epoch,
                                 device=self.device)
        try:
            for epoch in range(cfg.start_epoch, cfg.epochs):
                self.obs.epoch_start()
                profiler.epoch_begin(epoch)
                completed = self.train_epoch(
                    epoch, self._resume_step if epoch == cfg.start_epoch else 0,
                    profiler=profiler)
                if profiler.epoch_end():
                    self.log(f"=> wrote profiler trace to '{cfg.profile_dir}'")
                if (not self.preempted and self.preempt is not None
                        and self._preempt_agreed()):
                    self.preempted = True  # landed between the last poll and here
                if self.preempted:
                    # A step-granular checkpoint: --resume continues at the
                    # step reached (none done: the previous epoch's end).
                    self.log(f"=> preemption signal: checkpointing at epoch {epoch} step "
                             f"{completed} and exiting")
                    self.obs.log_event("preempt", step=self.global_step, epoch=epoch,
                                       step_in_epoch=completed)
                    if completed > 0:
                        self.save(epoch, completed)
                    else:
                        self.save(epoch - 1)
                    break
                acc1 = self.validate()
                self.log(f"Epoch {epoch} took {self.obs.epoch_end():.1f}s")
                is_best = acc1 > self.best_acc1
                self.best_acc1 = max(acc1, self.best_acc1)
                self.save(epoch, is_best=is_best)
        except BaseException as e:
            self.ro.dump_exception(e, self.global_step)
            raise
        finally:
            self.ro.disarm()   # before the guard: the signal dump chains to it
            if installed:
                self.preempt.uninstall()
                self.preempt = None
            profiler.epoch_end()
            self.ro.close(self.global_step - 1)
        return self.best_acc1
