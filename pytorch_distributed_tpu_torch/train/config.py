"""CLI and config of the image recipes, the port of
``pytorch_distributed_tpu/train/config.py``: the reference's flag surface
(``--data -a -j --epochs --start-epoch -b --lr --momentum --wd -p -e
--pretrained --seed``) and the JAX package's additions, as one dataclass,
plus ``--device`` (default ``cuda``).

Every flag is parsed.  ``check_ported`` exits naming the ROADMAP item that
will port a flag whose value differs from its default and whose layer is
not ported yet: fault tolerance beyond the in-step ``--nan-guard`` gate and
the checkpoints (A11) and observability beyond the metrics stream (A12:
the ledgers, the recompile watch, the flight recorder, live export and
alerts).  The metrics stream is ported: ``--metrics-jsonl``, ``--hb-dir``
/ ``--hb-interval``, ``--mfu``, ``--goodput``, ``--step-attr``,
``--telemetry-csv`` and ``--profile-dir`` / ``--profile-epochs`` /
``--profile-steps``, with the JAX package's help.  The
gradient-communication flags (``--grad-compress``, ``--zero``,
``--overlap``, ``--bucket-mb``) are ported with the JAX package's help.
``--dist-file`` is accepted and unused, as in the JAX package (the
bootstrap reads the launcher's environment).  So are ``--fused-ce`` and
``--fused-ce-mode``: the LM family's loss head, which the JAX image
``Trainer`` never reads either.  ``--sync-bn`` is the explicit step's
cross-replica BatchNorm (``train/trainer.py``).  ``--ckpt-backend
orbax`` exits too: orbax imports JAX, so the port keeps the msgpack format.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.train.checkpoint import ORBAX_MESSAGE

_FT = "A11 (fault tolerance: rollback policy, --elastic, the preemption guard)"
_OBS = "A12 (observability: ledgers, recompile watch, flight recorder, live export, alerts)"

# dest -> the ROADMAP item that will port it, for flags not ported yet.
NOT_PORTED = {
    **dict.fromkeys(("ft_rollback_k", "ft_check_every", "ft_lr_backoff",
                     "preempt_signals", "elastic", "min_ranks", "rescale_lr"), _FT),
    **dict.fromkeys(("watch_recompiles", "comm_ledger", "mem_ledger", "lowering_cache",
                     "flight_rec", "hang_timeout", "metrics_port", "alerts"), _OBS),
}


@dataclasses.dataclass
class Config:
    data: str = "/home/zhangzhi/Data/exports/ImageNet2012"
    arch: str = "resnet18"
    workers: int = 4
    worker_type: str = "thread"
    epochs: int = 90
    start_epoch: int = 0
    batch_size: int = 3200        # global batch (reference semantics)
    lr: float = 0.1
    lr_schedule: str = "step"     # "step" (reference) | "cosine"
    lr_warmup_epochs: int = 0
    momentum: float = 0.9
    weight_decay: float = 1e-4
    print_freq: int = 10
    evaluate: bool = False
    pretrained: bool = False
    seed: Optional[int] = None
    dist_file: Optional[str] = None
    precision: Optional[str] = None   # None = the recipe decides
    synthetic: bool = False
    synthetic_length: int = 1280
    wire: str = "f32"
    grad_compress: Optional[str] = None
    zero: Optional[str] = None
    overlap: str = "none"
    bucket_mb: float = 4.0
    accum_steps: int = 1
    local_rank: int = -1          # launch-line parity only
    image_size: int = 224
    num_classes: int = 1000
    stem: str = "conv7"
    fused_convbn: bool = False
    sync_bn: bool = False
    fused_ce_chunks: int = 0
    fused_ce_mode: str = "auto"
    resume: Optional[str] = None
    checkpoint_dir: str = "runs"
    ckpt_backend: str = "msgpack"
    save_steps: int = 0
    nan_guard: bool = False
    ft_rollback_k: int = 3
    ft_check_every: int = 10
    ft_lr_backoff: float = 0.5
    preempt_signals: str = "term"
    elastic: bool = False
    min_ranks: int = 1
    rescale_lr: str = "none"
    epoch_csv: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_epochs: Optional[str] = None
    profile_steps: Optional[str] = None
    telemetry_csv: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    hb_dir: Optional[str] = None
    hb_interval_s: float = 5.0
    mfu: bool = False
    goodput: bool = False
    watch_recompiles: bool = False
    comm_ledger: Optional[str] = None
    mem_ledger: Optional[str] = None
    lowering_cache: Optional[str] = None
    flight_rec: Optional[str] = None
    hang_timeout: float = 30.0
    metrics_port: int = 0
    alerts: Optional[str] = None
    step_attr: bool = False
    device: str = "cuda"
    nprocs: int = 1


_NOT_PORTED_HELP = "not ported yet (exits naming its ROADMAP item)"


def build_parser(description: str = "ImageNet Training on one CUDA card"
                 ) -> argparse.ArgumentParser:
    d = Config()
    names = models.model_names()
    p = argparse.ArgumentParser(description=description)
    add = p.add_argument
    add("--data", metavar="DIR", default=d.data,
        help="path to dataset: an ImageFolder tree with train/ and val/")
    add("-a", "--arch", metavar="ARCH", default=d.arch, choices=names,
        help="model architecture: " + " | ".join(names) + f" (default: {d.arch}; "
        "inception_v3 is canonical at --image-size 299)")
    add("-j", "--workers", default=d.workers, type=int, metavar="N",
        help="number of data loading workers (default: 4)")
    add("--worker-type", default=d.worker_type, choices=("thread", "process"),
        dest="worker_type", help="data workers: threads, or spawned processes")
    add("--epochs", default=d.epochs, type=int, metavar="N", help="number of total epochs")
    add("--start-epoch", default=d.start_epoch, type=int, metavar="N",
        help="manual epoch number (useful on restarts)")
    add("-b", "--batch-size", default=d.batch_size, type=int, metavar="N",
        help="mini-batch size")
    add("--lr", "--learning-rate", default=d.lr, type=float, metavar="LR",
        help="initial learning rate", dest="lr")
    add("--lr-schedule", default=d.lr_schedule, choices=("step", "cosine"),
        dest="lr_schedule", help="step = 0.1x every 30 epochs; cosine = warmup+cosine")
    add("--lr-warmup-epochs", default=d.lr_warmup_epochs, type=int, dest="lr_warmup_epochs",
        help="linear LR warmup epochs (cosine schedule)")
    add("--momentum", default=d.momentum, type=float, metavar="M", help="momentum")
    add("--wd", "--weight-decay", default=d.weight_decay, type=float, metavar="W",
        help="weight decay (default: 1e-4)", dest="weight_decay")
    add("-p", "--print-freq", default=d.print_freq, type=int, metavar="N",
        help="print frequency (default: 10)")
    add("-e", "--evaluate", dest="evaluate", action="store_true",
        help="evaluate model on validation set")
    add("--pretrained", dest="pretrained", action="store_true",
        help="start from $PTD_TPU_PRETRAINED_DIR/<arch>.msgpack (default directory "
        "pretrained/), a checkpoint either package saved for the same arch")
    add("--seed", default=d.seed, type=int, help="seed for initializing training")
    add("--dist-file", default=d.dist_file, type=str,
        help="accepted for launch-line parity and unused: the bootstrap reads the "
        "launcher's environment")
    add("--precision", default=d.precision, choices=("fp32", "bf16"),
        help="compute precision (weights stay f32); unset = recipe default")
    add("--synthetic", action="store_true", help="use a synthetic dataset")
    add("--synthetic-length", default=d.synthetic_length, type=int,
        help="samples per synthetic epoch")
    add("--image-size", default=d.image_size, type=int, help="train crop size (default 224)")
    add("--num-classes", default=d.num_classes, type=int,
        help="number of classes (synthetic mode; an ImageFolder tree sets it)")
    add("--accum-steps", default=d.accum_steps, type=int,
        help="split each batch into N strided microbatches, accumulate gradients, "
        "apply one update")
    add("--local_rank", default=-1, type=int, help="accepted for launch-line parity")
    add("--wire", default=d.wire, choices=("f32", "u8host", "u8", "native"),
        help="input pipeline: f32 per-sample normalize; u8host uint8 samples, flip and "
        "normalize per batch in C++; u8 uint8 to the card, normalized there; native C++ "
        "JPEG decode + crop per batch, uint8 to the card (--synthetic runs f32)")
    add("--grad-compress", default=d.grad_compress, choices=("none", "bf16", "int8", "fp8"),
        dest="grad_compress",
        help="gradient wire format for the DP sync: bf16 casts "
        "the all-reduce operand (Horovod fp16-compression "
        "analogue); int8/fp8 = per-block quantized all-reduce "
        "with error feedback (ops/qcomm.py) — true wire "
        "compression on the explicit-collectives step, numerics "
        "emulation under GSPMD; unset = recipe default")
    add("--zero", default=d.zero, choices=("none", "wus"),
        help="ZeRO-style weight-update sharding "
        "(arXiv:2004.13336): wus reduce-scatters gradients, "
        "keeps optimizer state sharded 1/N over the data axis, "
        "updates on the shard, and all-gathers the parameter "
        "delta — ~(N-1)/N of optimizer+gradient bytes reclaimed "
        "per device; composes with --grad-compress (both wire "
        "hops quantized); unset = recipe default (none)")
    add("--overlap", default=d.overlap, choices=("none", "bucketed"),
        help="comm-overlap scheduler (parallel/overlap.py): "
        "bucketed splits the explicit grad sync into "
        "~--bucket-mb MiB reverse-autodiff buckets issued as "
        "separate collectives that overlap the remaining "
        "backward; bit-equal numerics (requires the "
        "explicit-collectives step — horovod recipe, or "
        "lm_pretrain pure-DP)")
    add("--bucket-mb", default=d.bucket_mb, type=float, dest="bucket_mb", metavar="MIB",
        help="target gradient bucket size in MiB for --overlap "
        "bucketed (smaller = more overlap, more collectives)")
    add("--resume", default=d.resume, type=str, metavar="PATH",
        help="resume from a checkpoint file (either package's): weights, momentum, BN "
        "statistics and the exact step")
    add("--checkpoint-dir", default=d.checkpoint_dir, type=str,
        help="where checkpoint.msgpack (each epoch's end and every --save-steps) and "
        "model_best.msgpack go (default: runs)")
    add("--ckpt-backend", default=d.ckpt_backend, choices=("msgpack", "orbax"),
        dest="ckpt_backend", help="msgpack; orbax imports JAX and is not ported")
    add("--save-steps", default=d.save_steps, type=int, dest="save_steps", metavar="N",
        help="also checkpoint every N steps inside an epoch (0 = epoch ends only)")
    add("--nan-guard", action="store_true", dest="nan_guard",
        help="skip (inside the step, with no host sync) the update of a batch whose "
        "loss or gradient norm is not finite: parameters, momentum and BN statistics "
        "are restored")
    add("--ft-rollback-k", default=d.ft_rollback_k, type=int, dest="ft_rollback_k",
        metavar="K", help=_NOT_PORTED_HELP)
    add("--ft-check-every", default=d.ft_check_every, type=int, dest="ft_check_every",
        metavar="N", help=_NOT_PORTED_HELP)
    add("--ft-lr-backoff", default=d.ft_lr_backoff, type=float, dest="ft_lr_backoff",
        metavar="F", help=_NOT_PORTED_HELP)
    add("--preempt-signals", default=d.preempt_signals, type=str, dest="preempt_signals",
        metavar="SIGS", help=_NOT_PORTED_HELP)
    add("--elastic", action="store_true", dest="elastic", help=_NOT_PORTED_HELP)
    add("--min-ranks", default=d.min_ranks, type=int, dest="min_ranks", metavar="N",
        help=_NOT_PORTED_HELP)
    add("--rescale-lr", default=d.rescale_lr, choices=("none", "linear", "sqrt"),
        dest="rescale_lr", help=_NOT_PORTED_HELP)
    add("--epoch-csv", default=d.epoch_csv, type=str,
        help="append [timestamp, epoch_seconds] rows to this CSV")
    add("--profile-dir", default=d.profile_dir, type=str,
        help="write a torch.profiler Chrome trace (CPU and CUDA activity) of the "
        "first trained epoch of this run to this directory "
        "(narrow the window with --profile-epochs/--profile-steps)")
    add("--profile-epochs", default=d.profile_epochs, type=str, dest="profile_epochs",
        metavar="E[:F]", help="epoch window to trace under --profile-dir "
        "('2' or '2:4'); default: the first trained epoch")
    add("--profile-steps", default=d.profile_steps, type=str, dest="profile_steps",
        metavar="I[:J]", help="in-epoch step window narrowing the trace to steady "
        "state ('10' or '10:20'); default: whole epoch")
    add("--metrics-jsonl", default=d.metrics_jsonl, type=str, dest="metrics_jsonl",
        metavar="PATH", help="append one structured JSON record per train step "
        "(wall time, step-time EMA/p50/p95/max, throughput, "
        "loss, lr, grad/param norms) to this file; "
        "summarize with scripts/obs_report.py")
    add("--hb-dir", default=d.hb_dir, type=str, dest="hb_dir", metavar="DIR",
        help="shared heartbeat directory: each process "
        "appends {pid, step, t} beats; scripts/obs_report.py "
        "flags stragglers by step lag / beat age")
    add("--hb-interval", default=d.hb_interval_s, type=float, dest="hb_interval_s",
        metavar="SEC", help="minimum seconds between heartbeats (default 5)")
    add("--mfu", action="store_true",
        help="report per-step MFU/HFU in the metrics JSONL: the "
        "analytic FLOPs model for the arch (obs/flops.py) over the "
        "card's peak; supported for the ResNet and ViT families")
    add("--goodput", action="store_true",
        help="track the goodput/badput ledger live (nan-skips, "
        "rollback discards, preemption gaps, recompiles, "
        "stalls) and print the summary at end of fit; the "
        "post-hoc equivalent is scripts/obs_report.py over "
        "--metrics-jsonl")
    add("--step-attr", action="store_true", default=d.step_attr, dest="step_attr",
        help="exact per-step wall-time attribution "
        "(obs/stepattr.py): stamp attr_* fields — compute / "
        "exposed_comm / host_sync / data_wait / other, summing "
        "to step_time exactly — into every metrics record (the "
        "step ends in torch.cuda.synchronize() on a card)")
    add("--telemetry-csv", default=d.telemetry_csv, type=str,
        help="sample device memory stats to this CSV every 500ms "
        "during training (statistics.sh-in-process)")
    for flag, dest in (("--comm-ledger", "comm_ledger"), ("--mem-ledger", "mem_ledger"),
                       ("--lowering-cache", "lowering_cache"), ("--flight-rec", "flight_rec"),
                       ("--alerts", "alerts")):
        add(flag, default=getattr(d, dest), type=str, dest=dest, help=_NOT_PORTED_HELP)
    add("--watch-recompiles", action="store_true", dest="watch_recompiles",
        help=_NOT_PORTED_HELP)
    add("--hang-timeout", default=d.hang_timeout, type=float, dest="hang_timeout",
        metavar="SEC", help=_NOT_PORTED_HELP)
    add("--metrics-port", default=d.metrics_port, type=int, dest="metrics_port",
        metavar="PORT", help=_NOT_PORTED_HELP)
    add("--stem", default=d.stem, choices=("conv7", "space_to_depth"),
        help="ResNet stem: torchvision conv7 or the same function on 2x2 "
        "space-to-depth packed input")
    add("--fused-convbn", action="store_true", dest="fused_convbn",
        help="fold BN's backward into the stride-1 conv dgrad/wgrad (hand-written "
        "kernels K4 1x1 and K5 3x3); the state_dict is the same either way")
    add("--fused-ce", default=d.fused_ce_chunks, type=int, metavar="CHUNKS",
        dest="fused_ce_chunks", help="LM family: fused tied-head+CE loss in CHUNKS row "
        "blocks; accepted and unused by the image recipes, as in the JAX package")
    add("--fused-ce-mode", default=d.fused_ce_mode, choices=("auto", "replicated", "dp", "tp"),
        dest="fused_ce_mode", help="LM family: fused-CE sharding variant; accepted and "
        "unused by the image recipes")
    add("--sync-bn", action="store_true", dest="sync_bn",
        help="cross-replica BatchNorm for the explicit-collectives step (horovod_distributed): "
        "batch moments over every rank's batch; the DDP recipes have it already")
    add("--device", default=d.device, help="cuda (default) or cpu")
    return p


def check_ported(cfg: Config, parser: argparse.ArgumentParser) -> None:
    """Exit naming the ROADMAP item of the first flag set to a layer that is
    not ported yet."""
    if cfg.ckpt_backend == "orbax":
        raise SystemExit(f"--ckpt-backend orbax: {ORBAX_MESSAGE}")
    flags = {a.dest: a.option_strings[0] for a in parser._actions if a.option_strings}
    for dest, item in NOT_PORTED.items():
        value = getattr(cfg, dest)
        if value != parser.get_default(dest):
            raise SystemExit(f"{flags[dest]} is not ported to the PyTorch package yet: "
                             f"ROADMAP.md item {item}")


def parse_config(argv=None, description: str = "ImageNet Training on one CUDA card"
                 ) -> Config:
    """Parse ``argv`` into a ``Config``; exits on flags not ported yet."""
    parser = build_parser(description)
    cfg = Config(**vars(parser.parse_args(argv)))
    check_ported(cfg, parser)
    return cfg
