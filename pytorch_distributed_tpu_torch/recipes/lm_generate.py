"""Sample from a TransformerLM: the port of ``pytorch_distributed_tpu/recipes/lm_generate.py``.

Prefill the prompt into the KV caches and decode with greedy / temperature /
top-k / nucleus sampling (``models/generate.py``).  The flag surface is the
JAX recipe's plus ``--device`` (default ``cuda``; ``--device cpu`` runs the
plain versions of the kernels).  With a byte vocab (``--vocab 256``)
``--prompt`` is encoded as UTF-8 bytes and the continuation decoded back.

    python -m pytorch_distributed_tpu_torch.recipes.lm_generate --random-init \
        --prompt-tokens 1,2,3 -n 8

``--resume``, ``--quant``, ``--tp`` and ``--spec-draft`` are parsed but not
ported yet: each exits with the ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.utils.device import resolve_device

# Flags parsed for the JAX recipe's surface, each with the ROADMAP item
# (queue A) that will port it.
NOT_PORTED = {
    "quant": "A5 (int8 weight-only serving, --quant)",
    "spec_draft": "A6 (speculative decoding, --spec-draft)",
    "tp": "A7 (model-parallel decode, --tp)",
    "resume": "A8 (checkpoint loading, --resume)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sample from a TransformerLM")
    p.add_argument("--resume", default="",
                   help="checkpoint path from lm_pretrain (not ported yet)")
    p.add_argument("--random-init", action="store_true",
                   help="sample from a seeded random init (no checkpoint)")
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
                   help="model-parallel decode (not ported yet)")
    p.add_argument("--quant", choices=("", "int8"), default="",
                   help="int8 weight-only serving (not ported yet)")
    p.add_argument("--spec-draft", default="",
                   help="speculative decoding draft (not ported yet)")
    p.add_argument("--spec-d-model", type=int, default=0)
    p.add_argument("--spec-n-heads", type=int, default=0)
    p.add_argument("--spec-n-layers", type=int, default=0)
    p.add_argument("--spec-gamma", type=int, default=4)
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) not in ("", 1):
            raise SystemExit(f"--{dest.replace('_', '-')} is not ported to the "
                             f"PyTorch package yet: ROADMAP.md item {item}")
    if not args.random_init:
        raise SystemExit("provide --random-init (checkpoint loading is not "
                         f"ported yet: ROADMAP.md item {NOT_PORTED['resume']})")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = TransformerLM(vocab_size=args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          dtype=dtype, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    prompt = torch.from_numpy(_encode_prompt(args)).to(device)
    out = generate(model, prompt, args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, seed=args.seed)
    toks = out[0].tolist()
    print("tokens:", toks)
    if args.vocab >= 256 and args.prompt:
        # Byte-LM convention: ids < 256 are bytes; any other id renders as
        # U+FFFD so the text line never silently drops a generated token.
        text = b"".join(
            bytes([t]) if t < 256 else "�".encode() for t in toks
        ).decode("utf-8", "replace")
        print("text:", repr(args.prompt + text))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
