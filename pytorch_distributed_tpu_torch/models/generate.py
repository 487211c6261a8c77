"""Autoregressive generation for the LM: KV-cached decode with greedy or
temperature / top-k / nucleus sampling.

Port of ``pytorch_distributed_tpu/models/generate.py``.  The JAX package
compiles prefill plus a ``lax.scan`` over the steps into one program; here
the prompt prefills the per-layer caches in one eager forward and a Python
loop decodes one token per step against the filled prefix.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.models.quant import quantize_lm
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops.flash_attention import pick_attention_impl


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    """Temperature + top-k + nucleus filtering over ``[..., V]`` logits: the
    sampling distribution in logit form (f32, -inf outside the kept set).

    Top-k drops by value threshold, so every token tied with the k-th value
    is kept.  With top-k, the nucleus cutoff comes from the sorted k-vector;
    without it, from a stable full-vocab sort (ties kept in index order).
    ``temperature`` must be > 0 (greedy is the caller's argmax).
    """
    logits = logits.float() / temperature
    if top_k > 0:
        vals = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values
        cut = vals[..., -1:]
        if 0.0 < top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            mass_before = torch.cumsum(probs, dim=-1) - probs
            kept = torch.where(mass_before < top_p, vals,
                               torch.full_like(vals, float("inf")))
            cut = torch.maximum(cut, kept.amin(dim=-1, keepdim=True))
        return logits.masked_fill(logits < cut, float("-inf"))
    if 0.0 < top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        mass_before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
        drop = torch.empty_like(mass_before, dtype=torch.bool)
        drop.scatter_(-1, order, mass_before >= top_p)
        return logits.masked_fill(drop, float("-inf"))
    return logits


@torch.no_grad()
def generate(model: TransformerLM, prompt: torch.Tensor, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             seed: int = 0, flash_prefill: Optional[bool] = None,
             quant: str = "") -> torch.Tensor:
    """Decode ``max_new_tokens`` continuations of ``prompt [B, P]``.

    ``temperature=0`` is greedy argmax; ``temperature>0`` samples from
    softmax(logits/T) truncated to the ``top_k`` most likely tokens and/or
    the nucleus holding ``top_p`` mass (k first), with a ``torch.Generator``
    seeded from ``seed``.  ``flash_prefill=None`` takes the flash kernel for
    the prompt where ``pick_attention_impl`` picks it.  ``quant="int8"``
    decodes with the int8 weight-only twin of a full-precision ``model``
    (``models/quant.py``; a quantized model is used as it is).  Returns
    ``[B, max_new_tokens]`` int32 on the model's device.
    """
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if quant and not model.quant:
        model = quantize_lm(model)
    device = model.device
    prompt = torch.as_tensor(prompt, device=device)
    B, P = prompt.shape
    if flash_prefill is None:
        flash_prefill = pick_attention_impl(P, model.head_dim, device) == "flash"
    gen = torch.Generator(device=device).manual_seed(seed)

    def pick(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                              dim=-1)
        return torch.multinomial(probs, 1, generator=gen).squeeze(-1)

    cache = model.new_cache(B, P + max_new_tokens)
    # Under tensor parallelism every rank picks from the gathered logits
    # with the same generator, so the ranks feed the same token.
    last = (lambda x: model.full_logits(x[:, -1])) if getattr(model, "tp", 1) > 1 else (
        lambda x: x[:, -1])
    tok = pick(last(model(prompt, cache=cache, flash_prefill=flash_prefill)))
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok = pick(last(model(tok[:, None], cache=cache)))
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def tp_generate(model: TransformerLM, prompt: torch.Tensor, max_new_tokens: int,
                **kw) -> torch.Tensor:
    """Model-parallel decode: ``model`` holds this rank's Megatron shard
    (``TransformerLM(mesh=...)`` over a ``model`` group: qkv/fc1 column-,
    proj/fc2 row-parallel, the vocab-sharded embedding, head-sharded KV
    caches); every rank of the group calls it and gets the same tokens.
    The prompt takes the dense prefill, as the JAX ``tp_generate`` does
    (``flash_prefill=False``)."""
    kw.setdefault("flash_prefill", False)
    return generate(model, prompt, max_new_tokens, **kw)


def greedy_generate(model: TransformerLM, prompt: torch.Tensor,
                    max_new_tokens: int, **kw) -> torch.Tensor:
    """Greedy decode (``generate`` with temperature 0)."""
    if kw.get("temperature"):
        raise ValueError(
            "greedy_generate is temperature-0 by definition; call generate() "
            f"for sampling (got temperature={kw['temperature']})")
    kw.pop("temperature", None)
    return generate(model, prompt, max_new_tokens, temperature=0.0, **kw)
