"""LM pretraining on one device: the port of ``pytorch_distributed_tpu/recipes/lm_pretrain.py``.

Next-token training of the TransformerLM (``train/lm.py``) with f32 master
weights and ``--precision`` compute (bf16 by default), on the synthetic
affine token stream or on files (``--text-glob``), with the held-out eval
and an optional greedy decode at the end.  Attention takes the flash
kernels (K1 forward, K2 and K3 backward) where ``pick_attention_impl``
picks them: on the card at ``--seq-len`` >= 4096, 1024-aligned.

    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain \\
        --vocab 32000 --d-model 1024 --n-heads 16 --n-layers 12 \\
        --seq-len 4096 -b 4 --steps 20
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu \\
        --vocab 64 --d-model 32 --n-heads 4 --n-layers 1 --seq-len 32 -b 4 --steps 5

The flag surface is the JAX recipe's plus ``--device`` (default ``cuda``).
Every flag of a layer not ported yet (parallel layouts, fused CE, remat,
checkpoints, fault tolerance, observability) is parsed, and a value other
than its default exits naming the ROADMAP item that will port it.  The JAX
recipe's SIGTERM preemption guard is one of them: here SIGTERM ends the
process.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import greedy_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.train.lm import (
    LMTrainer,
    SyntheticTokenDataset,
    TextFileDataset,
    warmup_cosine_lr,
)
from pytorch_distributed_tpu_torch.utils.device import resolve_device

_PARALLEL = "A10 (model parallelism: --tp, --sp, --ep, --pp, --fsdp)"
_GRAD_COMM = "A9 (gradient-communication stack: --zero, --grad-compress, --overlap)"
_FT = "A11 (fault tolerance: --nan-guard, --elastic, the preemption guard)"
_OBS = "A12 (observability: metrics, heartbeats, ledgers, alerts)"
_CKPT = "A16 (train/checkpoint.py: --checkpoint-dir, --resume, --save-steps)"
# Flags parsed for the JAX recipe's surface but not ported, each with the
# ROADMAP item (queue A) that will port it.
NOT_PORTED = {
    "fused_ce": "A14 (fused tied-head cross-entropy, --fused-ce)",
    "fused_ce_mode": "A14 (fused tied-head cross-entropy, --fused-ce)",
    "remat": "A15 (rematerialisation, --remat)",
    **dict.fromkeys(("tp", "sp", "sp_impl", "ep", "moe_top_k", "pp",
                     "microbatches", "schedule", "pp_virtual", "fsdp"), _PARALLEL),
    **dict.fromkeys(("zero", "grad_compress", "overlap", "bucket_mb"), _GRAD_COMM),
    **dict.fromkeys(("checkpoint_dir", "resume", "save_steps"), _CKPT),
    **dict.fromkeys(("preempt_signals", "nan_guard", "ft_rollback_k",
                     "ft_check_every", "ft_lr_backoff", "elastic", "min_ranks",
                     "rescale_lr"), _FT),
    **dict.fromkeys(("metrics_jsonl", "hb_dir", "hb_interval_s", "mfu", "goodput",
                     "watch_recompiles", "comm_ledger", "mem_ledger",
                     "lowering_cache", "flight_rec", "hang_timeout",
                     "metrics_port", "alerts", "step_attr"), _OBS),
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
                   help="fused tied-head+CE loss (not ported yet)")
    p.add_argument("--fused-ce-mode", default="auto",
                   choices=("auto", "replicated", "dp", "tp"),
                   dest="fused_ce_mode", help="not ported yet")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation over strided microbatches")
    p.add_argument("--tp", type=int, default=1, help="not ported yet")
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
    p.add_argument("--remat", action="store_true", help="not ported yet")
    p.add_argument("--fsdp", action="store_true", help="not ported yet")
    p.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                   help="compute dtype; weights stay f32")
    p.add_argument("--zero", choices=("none", "wus"), default="none",
                   help="not ported yet")
    p.add_argument("--grad-compress", choices=("none", "bf16", "int8", "fp8"),
                   default="none", dest="grad_compress", help="not ported yet")
    p.add_argument("--overlap", choices=("none", "bucketed"), default="none",
                   help="not ported yet")
    p.add_argument("--bucket-mb", type=float, default=4.0, dest="bucket_mb",
                   metavar="MIB", help="not ported yet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-p", "--print-freq", type=int, default=10)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="not ported yet")
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="not ported yet")
    p.add_argument("--save-steps", type=int, default=0, dest="save_steps",
                   metavar="N", help="not ported yet")
    p.add_argument("--preempt-signals", type=str, default="term",
                   dest="preempt_signals", metavar="SIGS", help="not ported yet")
    p.add_argument("--nan-guard", action="store_true", dest="nan_guard",
                   help="not ported yet")
    p.add_argument("--ft-rollback-k", type=int, default=3, dest="ft_rollback_k",
                   metavar="K", help="not ported yet")
    p.add_argument("--ft-check-every", type=int, default=10,
                   dest="ft_check_every", metavar="N", help="not ported yet")
    p.add_argument("--ft-lr-backoff", type=float, default=0.5,
                   dest="ft_lr_backoff", metavar="F", help="not ported yet")
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
                   dest="metrics_jsonl", metavar="PATH", help="not ported yet")
    p.add_argument("--hb-dir", type=str, default=None, dest="hb_dir",
                   metavar="DIR", help="not ported yet")
    p.add_argument("--hb-interval", type=float, default=5.0,
                   dest="hb_interval_s", metavar="SEC", help="not ported yet")
    p.add_argument("--mfu", action="store_true", help="not ported yet")
    p.add_argument("--goodput", action="store_true", help="not ported yet")
    p.add_argument("--watch-recompiles", action="store_true",
                   dest="watch_recompiles", help="not ported yet")
    p.add_argument("--comm-ledger", type=str, default=None, dest="comm_ledger",
                   metavar="PATH", help="not ported yet")
    p.add_argument("--mem-ledger", type=str, default=None, dest="mem_ledger",
                   metavar="PATH", help="not ported yet")
    p.add_argument("--lowering-cache", type=str, default=None,
                   dest="lowering_cache", metavar="DIR", help="not ported yet")
    p.add_argument("--flight-rec", type=str, default=None, dest="flight_rec",
                   metavar="DIR", help="not ported yet")
    p.add_argument("--hang-timeout", type=float, default=30.0,
                   dest="hang_timeout", metavar="SEC", help="not ported yet")
    p.add_argument("--metrics-port", type=int, default=0, dest="metrics_port",
                   metavar="PORT", help="not ported yet")
    p.add_argument("--alerts", type=str, default=None, dest="alerts",
                   metavar="RULES", help="not ported yet")
    p.add_argument("--step-attr", action="store_true", dest="step_attr",
                   help="not ported yet")
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


def run(argv=None) -> LMTrainer:
    """Parse ``argv``, build the model and data, train, optionally decode;
    returns the trainer."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} is not ported to the "
                             f"PyTorch package yet: ROADMAP.md item {item}")
    if args.warmup_steps >= args.steps and args.warmup_steps > 0:
        raise SystemExit(f"--warmup-steps {args.warmup_steps} must be < "
                         f"--steps {args.steps} (no room for cosine decay)")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.text_glob:
        args.vocab = TextFileDataset.vocab  # before the model is built
    model = TransformerLM(vocab_size=args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          dtype=dtype, param_dtype=torch.float32, device=device)
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
    trainer = LMTrainer(model, dataset, args.batch_size, lr=args.lr,
                        eval_dataset=eval_dataset, eval_every=args.eval_every,
                        eval_batches=args.eval_batches, lr_schedule=schedule,
                        clip_grad_norm=args.clip_grad_norm,
                        accum_steps=args.accum_steps)
    final_loss = trainer.fit(args.steps, print_freq=args.print_freq)
    if args.generate > 0:
        prompt = torch.from_numpy(dataset.batch(0, 1)[:, :min(16, args.seq_len // 2)])
        toks = greedy_generate(model, prompt.to(device), args.generate)
        print(" * Generated:", " ".join(map(str, np.asarray(toks.cpu())[0])),
              flush=True)
    print(f" * Final loss {final_loss:.4f}", flush=True)
    return trainer


def main(argv=None) -> float:
    """Train as ``run`` does; returns the final step's loss."""
    return float(run(argv).losses[-1])


if __name__ == "__main__":
    main()
