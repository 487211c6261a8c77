"""LM pretraining, on one device or across ranks: the port of
``pytorch_distributed_tpu/recipes/lm_pretrain.py``.

Next-token training of the TransformerLM (``train/lm.py``) with f32 master
weights and ``--precision`` compute (bf16 by default), on the synthetic
affine token stream or on files (``--text-glob``), with the held-out eval
and an optional greedy decode at the end.  Attention takes the flash
kernels (K1 forward, K2 and K3 backward) where ``pick_attention_impl``
picks them: on the card at ``--seq-len`` >= 4096, 1024-aligned.
``--checkpoint-dir`` saves in the JAX package's format at the end (and every
``--save-steps``); ``--resume`` continues from such a file, either package's,
at its exact step.

    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain \\
        --vocab 32000 --d-model 1024 --n-heads 16 --n-layers 12 \\
        --seq-len 4096 -b 4 --steps 20
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu \\
        --vocab 64 --d-model 32 --n-heads 4 --n-layers 1 --seq-len 32 -b 4 --steps 5

``--fused-ce N`` computes the loss through the fused tied-head
cross-entropy (``ops/fused_ce.py``): the ``[B, L, vocab]`` logits never
exist at once.

Across ranks (``parallel/dist.py::initialize``: a launcher's environment,
``PTD_TPU_*``, SLURM or ``torch.distributed.run``) the recipe builds the
JAX recipe's non-pipelined mesh, ``data × model`` with ``model`` innermost
(``parallel/mesh.py``): data parallelism over every rank by default, each
rank training on its contiguous rows of the global batch; ``--tp N``
Megatron tensor parallelism over groups of N consecutive ranks
(``parallel/tp.py``); ``--fsdp`` the parameters and momentum sharded over
the data axis (``parallel/fsdp.py``).  Rank 0 writes the checkpoints, in the
whole model's JAX layout, so any mesh resumes any other's file::

    torchrun --nproc_per_node 4 -m pytorch_distributed_tpu_torch.recipes.lm_pretrain \
        --tp 2 --fsdp ...
    for r in 0 1; do PTD_TPU_COORDINATOR=127.0.0.1:29500 PTD_TPU_NUM_PROCESSES=2 \
        PTD_TPU_PROCESS_ID=$r python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain \
        --device cpu --tp 2 ... & done; wait

``--grad-compress bf16|int8|fp8`` (the numerics emulation on the averaged
gradient), ``--zero wus`` (the momentum in chunks over the data group) and
``--overlap bucketed`` with ``--bucket-mb`` (the explicit pure-DP step's
bucketed sync, on the real collectives) are the gradient-communication
stack of ``train/lm.py``.

The flag surface is the JAX recipe's plus ``--device`` (default ``cuda``).
Its argument checks run first, in its order (``--remat`` applies to the
pipeline stages only, so without ``--pp`` it exits with the JAX message).
``--metrics-jsonl``, ``--hb-dir`` / ``--hb-interval``, ``--mfu``,
``--goodput`` and ``--step-attr`` are the metrics stream of
``train/observe.py``; ``--flight-rec``, ``--hang-timeout``,
``--metrics-port`` and ``--alerts`` its death paths and live plane, with
the JAX recipe's help.  As in the JAX recipe, a ``PreemptionGuard`` on
``--preempt-signals`` (SIGTERM by default) is installed on the main thread
around ``fit``: on the signal the ranks agree to stop at a step boundary,
checkpoint the steps done (with ``--checkpoint-dir``) and return.
``--nan-guard`` with ``--ft-rollback-k``, ``--ft-check-every`` and
``--ft-lr-backoff`` is the divergence guard of ``ft/divergence.py``: a
non-finite step is skipped inside the step, and K consecutive ones roll
back to the last-good snapshot (the start, then every ``--save-steps``)
with the LR backed off.
Every flag of a layer not ported yet (sequence and expert parallelism,
the pipeline and its remat, elastic membership, the ledgers and the recompile watch) is parsed, and a value other than its
default exits naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import greedy_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM, lm_shapes
from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
from pytorch_distributed_tpu_torch.parallel import tp as tp_lib
from pytorch_distributed_tpu_torch.parallel.fsdp import apply_fsdp
from pytorch_distributed_tpu_torch.parallel.mesh import MeshSpec, build_mesh, device_for
from pytorch_distributed_tpu_torch.train.lm import (
    LMTrainer,
    SyntheticTokenDataset,
    TextFileDataset,
    warmup_cosine_lr,
)
from pytorch_distributed_tpu_torch.utils.preempt import PreemptionGuard, parse_signals

_PARALLEL = "A10 (model parallelism: --sp, --ep, --pp)"
_FT = "A11 (fault tolerance: --elastic)"
_OBS = "A12 (observability: ledgers, recompile watch)"
# Flags parsed for the JAX recipe's surface but not ported, each with the
# ROADMAP item (queue A) that will port it.
NOT_PORTED = {
    **dict.fromkeys(("sp", "sp_impl", "ep", "moe_top_k", "pp",
                     "microbatches", "schedule", "pp_virtual"), _PARALLEL),
    **dict.fromkeys(("elastic", "min_ranks", "rescale_lr"), _FT),
    **dict.fromkeys(("watch_recompiles", "comm_ledger", "mem_ledger",
                     "lowering_cache"), _OBS),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LM pretraining on one CUDA card")
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("-b", "--batch-size", type=int, default=32,
                   help="batch (sequences)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help=">0: linear warmup then cosine decay to 10%% of "
                        "--lr over --steps (fixed lr otherwise)")
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help=">0: global-norm gradient clipping")
    p.add_argument("--fused-ce", type=int, default=0, metavar="CHUNKS",
                   help="fused tied-head+CE loss in CHUNKS row blocks "
                        "(ops/fused_ce.py): the [B,L,vocab] logits tensor "
                        "never materializes; 0 = unfused")
    p.add_argument("--fused-ce-mode", default="auto",
                   choices=("auto", "replicated", "dp", "tp"),
                   dest="fused_ce_mode",
                   help="fused-CE sharding variant (auto picks from "
                        "the mesh and param specs; see "
                        "train/lm.py resolve_fused_ce_mode)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation over strided microbatches")
    p.add_argument("--tp", type=int, default=1,
                   help="Megatron tensor parallelism over a 'model' mesh "
                        "axis of this size (parallel/tp.py)")
    p.add_argument("--sp", type=int, default=1, help="not ported yet")
    p.add_argument("--sp-impl", choices=("ring", "a2a"), default="ring",
                   help="not ported yet")
    p.add_argument("--ep", type=int, default=1, help="not ported yet")
    p.add_argument("--moe-top-k", type=int, default=1, help="not ported yet")
    p.add_argument("--pp", type=int, default=1, help="not ported yet")
    p.add_argument("--microbatches", type=int, default=0, help="not ported yet")
    p.add_argument("--schedule", choices=("gpipe", "1f1b", "interleaved"),
                   default="gpipe", help="not ported yet")
    p.add_argument("--pp-virtual", type=int, default=2, dest="pp_virtual",
                   help="not ported yet")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the pipeline stages (requires --pp > 1; "
                        "not ported yet)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + momentum over the data axis "
                        "(FSDP/ZeRO-3 layout, parallel/fsdp.py)")
    p.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                   help="compute dtype; weights stay f32")
    p.add_argument("--zero", choices=("none", "wus"), default="none",
                   help="ZeRO-style weight-update sharding (parallel/"
                        "zero.py): 'wus' gives momentum leaves fsdp_specs "
                        "data-axis shardings (composed over the --tp/--pp "
                        "layout) while params stay in their declared "
                        "layout — 1/N optimizer bytes per device, same "
                        "numerics and checkpoint format.  Lighter than "
                        "--fsdp (which also shards the params; that is the "
                        "ZeRO-3 layout, this is ZeRO-1)")
    p.add_argument("--grad-compress", choices=("none", "bf16", "int8", "fp8"),
                   default="none", dest="grad_compress",
                   help="gradient-sync compression (ops/qcomm.py): bf16 "
                        "round-trip cast, or int8/fp8 block quantization "
                        "with error feedback.  The LM step is GSPMD, so "
                        "quantized modes run as a numerics emulation "
                        "under the default GSPMD step (wire bytes "
                        "unchanged; convergence effects real) — add "
                        "--overlap bucketed on a pure-DP run to switch to "
                        "the explicit shard_map step where the wire "
                        "really carries the compressed collectives")
    p.add_argument("--overlap", choices=("none", "bucketed"),
                   default="none",
                   help="comm-overlap scheduler (parallel/overlap.py): "
                        "bucketed runs the pure-DP step as explicit "
                        "shard_map collectives with ~--bucket-mb MiB "
                        "reverse-autodiff grad buckets, each issued as "
                        "its own psum so sync overlaps the remaining "
                        "backward; bit-equal numerics.  Pure DP only "
                        "(no --tp/--sp/--pp/--fsdp/--fused-ce/"
                        "--accum-steps/--zero/--elastic)")
    p.add_argument("--bucket-mb", type=float, default=4.0,
                   dest="bucket_mb", metavar="MIB",
                   help="target gradient bucket size in MiB for --overlap "
                        "bucketed (smaller = more overlap, more "
                        "collectives)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-p", "--print-freq", type=int, default=10)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="resume from a checkpoint: restores params/momentum "
                        "AND the exact step (the ft record), so the run "
                        "continues mid-stream instead of restarting")
    p.add_argument("--save-steps", type=int, default=0, dest="save_steps",
                   metavar="N",
                   help="also checkpoint every N steps (step-granular "
                        "resume: a lost process loses at most N steps); "
                        "0 = end-of-run only")
    p.add_argument("--preempt-signals", type=str, default="term",
                   dest="preempt_signals", metavar="SIGS",
                   help="comma-separated signals that trigger checkpoint-"
                        "and-exit at the next step boundary (default "
                        "'term'; add 'int' for interactive Ctrl-C runs)")
    p.add_argument("--nan-guard", action="store_true", dest="nan_guard",
                   help="divergence guard: skip non-finite steps in the step; "
                        "after --ft-rollback-k consecutive bad steps, roll "
                        "back to the last-good state with an LR backoff")
    p.add_argument("--ft-rollback-k", type=int, default=3,
                   dest="ft_rollback_k", metavar="K",
                   help="consecutive non-finite steps before rollback")
    p.add_argument("--ft-check-every", type=int, default=10,
                   dest="ft_check_every", metavar="N",
                   help="drain the guard's buffered flags every N steps "
                        "(one amortized host sync)")
    p.add_argument("--ft-lr-backoff", type=float, default=0.5,
                   dest="ft_lr_backoff", metavar="F",
                   help="LR multiplier applied at each rollback")
    p.add_argument("--elastic", action="store_true", dest="elastic",
                   help="not ported yet")
    p.add_argument("--min-ranks", type=int, default=1, dest="min_ranks",
                   metavar="N", help="not ported yet")
    p.add_argument("--rescale-lr", choices=("none", "linear", "sqrt"),
                   default="none", dest="rescale_lr", help="not ported yet")
    p.add_argument("--dataset-length", type=int, default=4096)
    p.add_argument("--text-glob", type=str, default=None,
                   help="train on real files: byte-level LM over this glob; "
                        "forces --vocab 256 and replaces the synthetic "
                        "dataset")
    p.add_argument("--metrics-jsonl", type=str, default=None,
                   dest="metrics_jsonl", metavar="PATH",
                   help="append one structured JSON record per train step "
                        "(step-time EMA/p50/p95, tokens/s, loss, lr, "
                        "grad/param norms) to this file; "
                        "summarize with scripts/obs_report.py")
    p.add_argument("--hb-dir", type=str, default=None, dest="hb_dir",
                   metavar="DIR",
                   help="shared heartbeat directory: each mesh process "
                        "appends {pid, step, t} beats; obs_report.py flags "
                        "stragglers by step lag / beat age")
    p.add_argument("--hb-interval", type=float, default=5.0,
                   dest="hb_interval_s", metavar="SEC",
                   help="minimum seconds between heartbeats (default 5)")
    p.add_argument("--mfu", action="store_true",
                   help="report per-step MFU/HFU in the metrics JSONL: the "
                        "analytic LM FLOPs model (obs/flops.py — fused-CE "
                        "accounted) over the cards' peak FLOPs")
    p.add_argument("--goodput", action="store_true",
                   help="track the goodput/badput ledger live (nan-skips, "
                        "rollback discards, preemption gaps, recompiles, "
                        "stalls) and print the summary at end of fit")
    p.add_argument("--watch-recompiles", action="store_true",
                   dest="watch_recompiles", help="not ported yet")
    p.add_argument("--comm-ledger", type=str, default=None, dest="comm_ledger",
                   metavar="PATH", help="not ported yet")
    p.add_argument("--mem-ledger", type=str, default=None, dest="mem_ledger",
                   metavar="PATH", help="not ported yet")
    p.add_argument("--lowering-cache", type=str, default=None,
                   dest="lowering_cache", metavar="DIR", help="not ported yet")
    p.add_argument("--flight-rec", type=str, default=None,
                   dest="flight_rec", metavar="DIR",
                   help="flight recorder (obs/flightrec.py): bounded "
                        "in-memory ring of step/collective/ft events "
                        "dumped to DIR/flightrec_rank<k>.json on any "
                        "death path (signal, checkpoint corruption, "
                        "unhandled exception, hang watchdog); merge dumps "
                        "with tools/postmortem.py")
    p.add_argument("--hang-timeout", type=float, default=30.0,
                   dest="hang_timeout", metavar="SEC",
                   help="hang-watchdog floor: flag a step exceeding "
                        "max(SEC, 4×p95), emit a `hang` ft_event with the "
                        "last-entered collective, and dump the flight "
                        "ring pre-mortem (needs --flight-rec)")
    p.add_argument("--metrics-port", type=int, default=0,
                   dest="metrics_port", metavar="PORT",
                   help="serve live Prometheus metrics on PORT + rank "
                        "(obs/export.py; one daemon thread per rank, "
                        "latest drained record; 0 disables; watch the "
                        "fleet with tools/obs_live.py)")
    p.add_argument("--alerts", type=str, default=None, dest="alerts",
                   metavar="RULES",
                   help="declarative alert rules (obs/alerts.py): a JSON "
                        "rules file or 'default' for the built-in set; "
                        "firing alerts are booked as `alert` ft_events "
                        "in the metrics JSONL and exported to /metrics")
    p.add_argument("--step-attr", action="store_true", dest="step_attr",
                   help="exact per-step wall-time attribution "
                        "(obs/stepattr.py): stamp attr_* fields — compute "
                        "/ exposed_comm / host_sync / data_wait / other, "
                        "summing to step_time exactly — into every "
                        "metrics record (the step ends in "
                        "torch.cuda.synchronize() on a card)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run held-out eval (loss/ppl) every N steps; "
                        "0 = end-of-run only")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--no-eval", action="store_true",
                   help="disable the held-out eval entirely")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedy-decode N tokens from a "
                        "dataset prompt")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def check_args(args) -> None:
    """The JAX recipe's checks of its arguments, in its order and words
    (those that need no device count)."""
    if args.ep > 1 and (args.tp > 1 or args.sp > 1 or args.pp > 1):
        raise SystemExit("--ep is exclusive (MoE model variant); "
                         "--tp composes with --sp or --pp")
    if args.warmup_steps >= args.steps and args.warmup_steps > 0:
        raise SystemExit(f"--warmup-steps {args.warmup_steps} must be < "
                         f"--steps {args.steps} (no room for cosine decay)")
    if args.sp > 1 and args.seq_len % args.sp:
        raise SystemExit(f"--seq-len {args.seq_len} not divisible by "
                         f"--sp {args.sp}")
    if args.schedule in ("1f1b", "interleaved") and args.pp <= 1:
        raise SystemExit(f"--schedule {args.schedule} requires --pp > 1")
    if args.schedule in ("1f1b", "interleaved") and (args.tp > 1
                                                     or args.sp > 1):
        raise SystemExit(f"--schedule {args.schedule} supports plain "
                         "stages; use gpipe for TP/SP-in-stage")
    if args.schedule == "interleaved":
        micro = args.microbatches or args.pp
        if micro % args.pp:
            raise SystemExit(f"--schedule interleaved needs --microbatches "
                             f"{micro} divisible by --pp {args.pp}")
        if args.n_layers % (args.pp * args.pp_virtual):
            raise SystemExit(f"--n-layers {args.n_layers} not divisible by "
                             f"pp*V = {args.pp * args.pp_virtual}")
    if args.remat and args.pp <= 1:
        raise SystemExit("--remat applies to the pipeline stages "
                         "(requires --pp > 1)")
    if args.fused_ce and args.pp > 1:
        raise SystemExit("--fused-ce applies to the non-pipelined loss "
                         "path (the pipeline schedules own their loss "
                         "head); drop --pp or --fused-ce")
    if args.accum_steps > 1 and args.pp > 1:
        raise SystemExit("--accum-steps with --pp is redundant: the pipeline "
                         "schedule already microbatches; raise "
                         "--microbatches instead")
    if args.overlap == "bucketed" and (
            args.tp > 1 or args.sp > 1 or args.ep > 1 or args.pp > 1
            or args.fsdp or args.fused_ce or args.accum_steps > 1
            or args.zero != "none" or args.elastic):
        raise SystemExit("--overlap bucketed runs the explicit shard_map "
                         "pure-DP step only; drop --tp/--sp/--ep/--pp/"
                         "--fsdp/--fused-ce/--accum-steps/--zero/--elastic")


def check_mesh_args(args, n: int) -> None:
    """The JAX recipe's checks that need the device count ``n``, in its
    order and words (those of layouts not ported exit before)."""
    if n % (args.tp * args.sp * args.ep * args.pp):
        raise SystemExit(f"{n} devices not divisible by tp*sp*ep*pp")
    if args.generate > 0 and (args.tp > 1 or args.sp > 1 or args.ep > 1
                              or args.pp > 1):
        raise SystemExit("--generate supports plain dp runs only")


def run(argv=None, before_fit=None) -> LMTrainer:
    """Parse ``argv``, join the launcher's process group (if any), build the
    mesh, the model and the data, train, optionally decode; returns the
    trainer (its ``ctx`` still up; ``main`` shuts it down).  ``before_fit``:
    called with the built trainer just before ``fit``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(args)
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} is not ported to the "
                             f"PyTorch package yet: ROADMAP.md item {item}")
    ctx = initialize(device=args.device)
    try:
        return _run(args, ctx, before_fit)
    except BaseException:
        shutdown(ctx)
        raise


def _run(args, ctx, before_fit=None) -> LMTrainer:
    n = ctx.process_count
    check_mesh_args(args, n)
    device = device_for(ctx, args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.text_glob:
        args.vocab = TextFileDataset.vocab  # before the model is built
    # The composable data x model mesh: the data axis takes the remaining
    # ranks; 'model' is innermost, so a tensor group is consecutive ranks.
    axes, shape = ["data"], [n // args.tp]
    if args.tp > 1:
        axes.append("model")
        shape.append(args.tp)
    mesh = build_mesh(MeshSpec(tuple(axes), tuple(shape)), ctx)
    tp_lib.check_tp(lm_shapes(args.vocab, args.d_model, args.n_layers), mesh.size("data"),
                    args.tp)
    model = TransformerLM(vocab_size=args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          dtype=dtype, param_dtype=torch.float32, device=device, mesh=mesh)
    if args.fsdp:
        apply_fsdp(model, mesh)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    if args.text_glob:
        # hold out the 10% tail for eval only when eval will run
        train_span = (0.0, 1.0) if args.no_eval else (0.0, 0.9)
        try:
            dataset = TextFileDataset(args.text_glob, args.seq_len, span=train_span)
        except ValueError as e:
            raise SystemExit(f"--text-glob corpus too small for --seq-len "
                             f"{args.seq_len} ({e}); add files or shorten "
                             "--seq-len") from e
    else:
        dataset = SyntheticTokenDataset(args.dataset_length, args.seq_len,
                                        args.vocab, seed=args.seed)
    if args.no_eval:
        eval_dataset = None
    elif args.text_glob:
        try:
            eval_dataset = TextFileDataset(args.text_glob, args.seq_len,
                                           span=(0.9, 1.0))
        except ValueError as e:
            raise SystemExit(f"the held-out 10% corpus tail is too small for "
                             f"--seq-len {args.seq_len} ({e}); add files, "
                             "shorten --seq-len, or pass --no-eval") from e
    else:
        eval_dataset = SyntheticTokenDataset(
            max(args.dataset_length // 10, args.batch_size), args.seq_len,
            args.vocab, seed=args.seed + 1)
    schedule = (warmup_cosine_lr(args.lr, args.warmup_steps, args.steps)
                if args.warmup_steps > 0 else None)
    # The preemption guard on --preempt-signals, installed on the main
    # thread (Python's rule for signal handlers) and taken down after fit.
    guard = None
    if threading.current_thread() is threading.main_thread():
        guard = PreemptionGuard(signals=parse_signals(args.preempt_signals)).install()
    try:
        try:
            trainer = LMTrainer(model, dataset, args.batch_size, lr=args.lr,
                                eval_dataset=eval_dataset, eval_every=args.eval_every,
                                eval_batches=args.eval_batches, lr_schedule=schedule,
                                clip_grad_norm=args.clip_grad_norm,
                                accum_steps=args.accum_steps,
                                fused_ce_chunks=args.fused_ce,
                                fused_ce_mode=args.fused_ce_mode,
                                checkpoint_dir=args.checkpoint_dir,
                                save_steps=args.save_steps, resume=args.resume,
                                grad_compress=args.grad_compress, zero=args.zero,
                                overlap=args.overlap, bucket_mb=args.bucket_mb, mesh=mesh,
                                metrics_jsonl=args.metrics_jsonl, hb_dir=args.hb_dir,
                                hb_interval_s=args.hb_interval_s, mfu=args.mfu,
                                goodput=args.goodput, step_attr=args.step_attr, preempt=guard,
                                flight_rec=args.flight_rec, hang_timeout=args.hang_timeout,
                                metrics_port=args.metrics_port, alerts=args.alerts,
                                nan_guard=args.nan_guard, ft_rollback_k=args.ft_rollback_k,
                                ft_check_every=args.ft_check_every,
                                ft_lr_backoff=args.ft_lr_backoff)
        except NotImplementedError as e:  # an orbax checkpoint directory
            raise SystemExit(str(e)) from e
        trainer.ctx = ctx
        if before_fit is not None:
            before_fit(trainer)
        final_loss = trainer.fit(args.steps, print_freq=args.print_freq)
    finally:
        if guard is not None:
            guard.uninstall()
    if args.generate > 0:  # plain-dp only, validated with the args above
        prompt = torch.from_numpy(dataset.batch(0, 1)[:, :min(16, args.seq_len // 2)])
        toks = greedy_generate(model, prompt.to(device), args.generate)
        print(" * Generated:", " ".join(map(str, np.asarray(toks.cpu())[0])),
              flush=True)
    print(f" * Final loss {final_loss:.4f}", flush=True)
    return trainer


def main(argv=None) -> float:
    """Train as ``run`` does, then leave the process group; returns the
    final step's loss."""
    trainer = run(argv)
    shutdown(trainer.ctx)
    return float(trainer.losses[-1])


if __name__ == "__main__":
    main()
