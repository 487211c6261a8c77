"""Decoder-only transformer LM, the port of ``pytorch_distributed_tpu/models/transformer.py``.

Pre-LN blocks, RoPE positions (half-split form, base 10000), GELU MLP at 4x
width, tied output head, f32 layernorm and attention softmax under a bf16
compute dtype.  The numerics follow the flax modules:

- LayerNorm uses eps 1e-6 and runs in f32;
- GELU is the tanh approximation (flax ``nn.gelu``'s default);
- Dense and embedding layers compute in the module dtype ``dtype``; their
  weights are kept in ``param_dtype`` and cast to ``dtype`` at each use, as
  flax does.  ``param_dtype`` defaults to ``dtype`` (serving: no cast per
  decode step, the same values); the trainer keeps f32 weights, so SGD
  updates an f32 master copy as the JAX step does;
- the residual stream stays in the module dtype;
- the tied head multiplies in the module dtype and returns f32 logits.

``attn_impl`` ("auto" | "flash" | "dense") picks the attention of the
no-cache forward, as the JAX module's field does; flash goes through
``flash_attention_fn``, which carries attention's gradient (K2, K3).

The single-device dense and flash paths and the KV-cached decode path with
flash prefill are ported.  MoE, ring / all-to-all sequence parallelism,
remat and int8 weights are still to port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops.flash_attention import (
    ATTN_IMPLS,
    flash_attention,
    flash_attention_fn,
    flash_attention_reference,
    pick_attention_impl,
)
from pytorch_distributed_tpu_torch.parallel.ring import dense_attention
from pytorch_distributed_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` with ``dtype``: input, kernel and bias cast to the
    compute dtype at use (no-ops when the weights are kept in it)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def rope(x: torch.Tensor, base: float = 10000.0, offset: int = 0) -> torch.Tensor:
    """Rotary position embedding over [B, L, H, D]; ``offset`` shifts the
    positions for KV-cached decoding.  f32 math, cast back to x's dtype."""
    B, L, H, D = x.shape
    half = D // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    pos = offset + torch.arange(L, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]                               # [L, half]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """One layer's decode cache.  ``key`` and ``value`` are preallocated
    [B, max_len, H, D] tensors in the module dtype, written in place at
    ``index`` (the JAX module returns a new cache from every call instead)."""

    key: torch.Tensor
    value: torch.Tensor
    index: int = 0


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 device, param_dtype: torch.dtype, attn_impl: str):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=False,
                             dtype=param_dtype, device=device)
        self.proj = nn.Linear(d_model, d_model, bias=False, dtype=param_dtype,
                              device=device)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                flash_prefill: bool = False) -> torch.Tensor:
        B, L, C = x.shape
        D = C // self.n_heads
        qkv = dense(self.qkv, x, self.dtype)
        # Contiguous thirds q | k | v, each viewed as [B, L, H, D] in place.
        q, k, v = (t.view(B, L, self.n_heads, D) for t in qkv.split(C, dim=-1))
        if cache is not None:
            out = self._decode_attend(q, k, v, cache, flash_prefill)
        else:
            q, k = rope(q), rope(k)
            if pick_attention_impl(L, D, x.device, self.attn_impl) == "flash":
                out = flash_attention_fn(q, k, v, True)
            else:
                out = dense_attention(q, k, v, causal=True)
        return dense(self.proj, out.reshape(B, L, C), self.dtype)

    def _decode_attend(self, q, k, v, cache: KVCache, flash_prefill: bool):
        """KV-cached attention: the new tokens' k/v land in the cache at the
        running index (a prefill writes the whole prompt, a decode step one
        token); q attends over the filled prefix through a position mask."""
        L = q.shape[1]
        idx, max_len = cache.index, cache.key.shape[1]
        if idx + L > max_len:
            raise ValueError(f"KV cache overflow: {idx} + {L} > {max_len}")
        q = rope(q, offset=idx)
        k = rope(k, offset=idx)
        cache.key[:, idx:idx + L] = k
        cache.value[:, idx:idx + L] = v
        cache.index = idx + L
        if L > 1 and flash_prefill:
            # Prefill through the fused kernel: a multi-token block at cache
            # index 0 is the whole prompt, so causal attention within it is
            # the whole answer.  A later chunk needs the cache path below.
            if idx != 0:
                raise ValueError("flash prefill needs the prompt at cache "
                                 f"index 0, got index {idx}")
            return flash_attention(q, k, v, True)[0]
        # The whole max_len cache, positions past the query masked out.
        return flash_attention_reference(q, cache.key, cache.value, True,
                                         q_offset=idx)[0]


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 device, param_dtype: torch.dtype, attn_impl: str):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.attn = SelfAttention(d_model, n_heads, dtype, device, param_dtype,
                                  attn_impl)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(d_model, 4 * d_model, dtype=param_dtype,
                             device=device)
        self.fc2 = nn.Linear(4 * d_model, d_model, dtype=param_dtype,
                             device=device)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                flash_prefill: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()), cache, flash_prefill)
        h = dense(self.fc1, self.ln2(x.float()), self.dtype)
        return x + dense(self.fc2, F.gelu(h, approximate="tanh"), self.dtype)


class TransformerLM(nn.Module):
    """Next-token LM: ``forward(tokens [B, L]) -> f32 logits [B, L, vocab]``.

    With ``cache`` (from ``new_cache``) the call runs in decode mode and
    advances the caches in place; ``flash_prefill`` then sends a multi-token
    prompt at index 0 through the flash kernel.
    """

    def __init__(self, vocab_size: int = 32000, d_model: int = 512,
                 n_heads: int = 8, n_layers: int = 8, dtype=torch.float32,
                 device="cuda", param_dtype=None, attn_impl: str = "auto"):
        super().__init__()
        device = resolve_device(device)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.embed = nn.Embedding(vocab_size, d_model, dtype=param_dtype,
                                  device=device)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, dtype, device, param_dtype, attn_impl)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[KVCache]] = None,
                flash_prefill: bool = False) -> torch.Tensor:
        if cache is not None and len(cache) != len(self.blocks):
            raise ValueError(f"{len(cache)} caches for {len(self.blocks)} blocks")
        x = self.embed(tokens).to(self.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if cache is None else cache[i], flash_prefill)
        x = self.ln_f(x.float())
        # Tied head, multiplied in the module dtype like flax's embed.attend.
        return (x.to(self.dtype) @ self.embed.weight.to(self.dtype).T).float()

    def new_cache(self, batch: int, max_len: int) -> List[KVCache]:
        """Zeroed per-layer caches at index 0."""
        shape = (batch, max_len, self.n_heads, self.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return [KVCache(zeros(), zeros()) for _ in self.blocks]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random init from ``generator`` with the flax defaults'
        distributions: Dense kernels lecun-normal (truncated at two standard
        deviations), the embedding normal with std 1/sqrt(d_model), biases
        zero, LayerNorm scale one."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
                w = torch.empty(mod.weight.shape, device=self.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        w = torch.empty(self.embed.weight.shape, device=self.device)
        w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)
        self.embed.weight.copy_(w)
        return self
