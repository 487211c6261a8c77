"""Sample from a TransformerLM: the port of ``pytorch_distributed_tpu/recipes/lm_generate.py``.

Load a checkpoint written by ``lm_pretrain`` of either package (the msgpack
file; the model flags must match its arch), prefill the prompt into the KV caches and decode with greedy / temperature /
top-k / nucleus sampling (``models/generate.py``).  The flag surface is the
JAX recipe's plus ``--device`` (default ``cuda``; ``--device cpu`` runs the
plain versions of the kernels).  With a byte vocab (``--vocab 256``)
``--prompt`` is encoded as UTF-8 bytes and the continuation decoded back.

    python -m pytorch_distributed_tpu_torch.recipes.lm_generate \
        --resume runs/lm/checkpoint.msgpack --vocab 256 --d-model 256 \
        --n-heads 8 --n-layers 4 --prompt "def main(" -n 64
    python -m pytorch_distributed_tpu_torch.recipes.lm_generate --random-init \
        --prompt-tokens 1,2,3 -n 8

``--quant int8`` decodes with int8 weight-only block kernels, quantized
after ``--resume`` (``models/quant.py``); the prompt still prefills through
the flash kernel where it is picked.  ``--spec-draft PATH|random`` decodes
by speculation (``models/speculative.py``) with a draft of ``--spec-*``
width (JAX defaults: a quarter of the target's), loaded from an
``lm_pretrain`` checkpoint or random, and prints the JAX stats line.

``--tp N`` decodes Megatron-sharded over N ranks of a ``model`` group
(``models/generate.py::tp_generate``): run it under a launcher with N
ranks (``torchrun --nproc_per_node N``, or ``PTD_TPU_*`` with ``--device
cpu`` over gloo); each rank builds the whole model, quantizes it when
asked, keeps its part, and rank 0 prints the tokens.  Orbax checkpoint
directories exit: orbax imports JAX.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import generate, tp_generate
from pytorch_distributed_tpu_torch.models.quant import quantize_lm
from pytorch_distributed_tpu_torch.models.speculative import speculative_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.train.checkpoint import load_checkpoint
from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
from pytorch_distributed_tpu_torch.parallel.mesh import MeshSpec, build_mesh, device_for
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sample from a TransformerLM")
    p.add_argument("--resume", default="",
                   help="checkpoint path (msgpack file) from lm_pretrain; "
                        "model flags must match its arch")
    p.add_argument("--random-init", action="store_true",
                   help="skip the checkpoint and sample from fresh init "
                        "(smoke/testing)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--prompt", default="",
                   help="text prompt (byte-encoded; requires --vocab >= 256)")
    p.add_argument("--prompt-tokens", default="",
                   help="comma-separated token ids (alternative to --prompt)")
    p.add_argument("-n", "--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=("fp32", "bf16"), default="fp32")
    p.add_argument("--tp", type=int, default=1,
                   help="model-parallel decode over this many ranks "
                        "(Megatron-sharded params and KV caches)")
    p.add_argument("--quant", choices=("", "int8"), default="",
                   help="int8 = weight-only quantized block kernels")
    p.add_argument("--spec-draft", default="",
                   help="enable speculative decoding: draft checkpoint "
                        "path, or 'random' for a fresh-init draft (smoke)")
    p.add_argument("--spec-d-model", type=int, default=0,
                   help="draft d_model (default: max(32, target // 4))")
    p.add_argument("--spec-n-heads", type=int, default=0,
                   help="draft n_heads (default: max(1, target // 4))")
    p.add_argument("--spec-n-layers", type=int, default=0,
                   help="draft n_layers (default: max(1, target // 4))")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per target scoring pass")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _encode_prompt(args) -> np.ndarray:
    if args.prompt_tokens:
        toks = [int(t) for t in args.prompt_tokens.split(",")]
    elif args.prompt:
        if args.vocab < 256:
            raise SystemExit("--prompt needs --vocab >= 256 (byte tokens); "
                             "use --prompt-tokens for small vocabs")
        toks = list(args.prompt.encode("utf-8"))
    else:
        raise SystemExit("provide --prompt or --prompt-tokens")
    bad = [t for t in toks if not 0 <= t < args.vocab]
    if bad:
        raise SystemExit(f"prompt tokens out of range [0,{args.vocab}): {bad}")
    return np.asarray(toks, np.int32)[None, :]


def _load(path: str, model) -> dict:
    """``load_checkpoint`` into ``model``; returns the file's metadata."""
    try:
        return load_checkpoint(path, model)[1]
    except NotImplementedError as e:  # an orbax checkpoint directory
        raise SystemExit(str(e)) from e


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.spec_draft and args.tp > 1:
        raise SystemExit("--spec-draft is batch-1 single-device "
                         "serving; it does not compose with --tp")
    if not args.random_init and not args.resume:
        raise SystemExit("provide --resume CHECKPOINT (or --random-init)")
    if args.tp > 1:
        ctx = initialize(device=args.device)
        try:
            return _main_tp(args, ctx)
        finally:
            shutdown(ctx)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = _load_model(args, device, dtype)
    prompt = torch.from_numpy(_encode_prompt(args)).to(device)
    if args.spec_draft:
        draft = TransformerLM(
            vocab_size=args.vocab,
            d_model=args.spec_d_model or max(32, args.d_model // 4),
            n_heads=args.spec_n_heads or max(1, args.n_heads // 4),
            n_layers=args.spec_n_layers or max(1, args.n_layers // 4),
            dtype=dtype, device=device)
        draft.init_weights(torch.Generator(device=device).manual_seed(args.seed + 1))
        if args.spec_draft != "random":
            meta = _load(args.spec_draft, draft)
            print(f"loaded draft {args.spec_draft} (epoch {meta.get('epoch')})")
        out, stats = speculative_generate(
            model, draft, prompt, args.max_new_tokens, gamma=args.spec_gamma,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed, quant=args.quant)
        print(f"speculative: {stats['target_passes']} target passes for "
              f"{stats['tokens']} tokens "
              f"({stats['tokens_per_target_pass']:.2f} tok/pass, "
              f"mean accepted {stats['mean_accepted']:.2f}/{args.spec_gamma})")
    else:
        out = generate(model, prompt, args.max_new_tokens,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, seed=args.seed, quant=args.quant)
    _print(args, out)
    return 0


def _load_model(args, device, dtype, quantize: bool = False):
    """The whole model from ``--seed`` or ``--resume``; f32 weights when
    they will be quantized (the scales come from the checkpoint's own
    numbers, as in the JAX recipe), quantized here when ``quantize``."""
    model = TransformerLM(vocab_size=args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers, dtype=dtype,
                          device=device, param_dtype=torch.float32 if args.quant else None)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    if args.resume:
        meta = _load(args.resume, model)
        print(f"loaded {args.resume} (epoch {meta.get('epoch')}, "
              f"arch {meta.get('arch') or 'transformer_lm'})")
    return quantize_lm(model) if quantize and args.quant else model


def _main_tp(args, ctx) -> int:
    """``--tp``: the mesh ``("model",)`` over the launcher's ranks; each
    rank keeps its shard of the whole (quantized) model and decodes with
    the others."""
    mesh = build_mesh(MeshSpec(("model",), (args.tp,)), ctx)
    device = device_for(ctx, args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    full = _load_model(args, device, dtype, quantize=True)
    model = TransformerLM(**{**full.config, "mesh": mesh}).load_full_state_dict(
        full.state_dict()).requires_grad_(False)
    del full
    prompt = torch.from_numpy(_encode_prompt(args)).to(device)
    out = tp_generate(model, prompt, args.max_new_tokens, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    if mesh.is_primary:
        _print(args, out)
    return 0


def _print(args, out) -> None:
    toks = out[0].tolist()
    print("tokens:", toks)
    if args.vocab >= 256 and args.prompt:
        # Byte-LM convention: ids < 256 are bytes; any other id renders as
        # U+FFFD so the text line never silently drops a generated token.
        text = b"".join(
            bytes([t]) if t < 256 else "�".encode() for t in toks
        ).decode("utf-8", "replace")
        print("text:", repr(args.prompt + text))


if __name__ == "__main__":
    raise SystemExit(main())
