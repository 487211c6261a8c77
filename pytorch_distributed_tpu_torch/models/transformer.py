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
``quant="int8"`` makes every block's ``qkv``, ``proj``, ``fc1`` and ``fc2``
a ``models/quant.py`` ``QuantDense`` (int8 weights, f32 scales), in decode
mode and in the no-cache forward alike; the embedding, tied head and norms
stay full precision.  ``return_hidden`` gives the pre-head states for the
fused tied-head loss (``ops/fused_ce.py``).

``mesh``: Megatron tensor parallelism over the mesh's ``model`` axis
(``parallel/tp.py``): each rank holds its heads of ``qkv`` / ``proj``, its
part of ``fc1`` / ``fc2`` and its vocab rows of the embedding; a replicated
activation enters ``qkv`` and ``fc1`` through the identity-forward /
all-reduce-backward function, ``proj`` and ``fc2`` are followed by one
all-reduce each (``fc2``'s bias added once, after it), the lookup is masked
to the rank's rows and all-reduced, and the tied head gives the rank's
``[.., V/tp]`` logits (``full_logits`` gathers them).  Attention runs on
the rank's own heads, through K1-K3 where flash is picked.  ``fsdp``
(``parallel/fsdp.py``): the parameters are this rank's data shards,
gathered around each block's forward and again in its backward.
``init_weights`` initialises the full model from the generator and keeps
this rank's part, so every mesh starts from the same weights.

MoE, ring / all-to-all sequence parallelism and the pipeline's remat are
still to port (ROADMAP.md item A10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.quant import QuantDense, block_linear, check_quant
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    ATTN_IMPLS,
    flash_attention,
    flash_attention_fn,
    flash_attention_reference,
    pick_attention_impl,
)
from pytorch_distributed_tpu_torch.parallel import tp as tp_lib
from pytorch_distributed_tpu_torch.parallel.ring import dense_attention
from pytorch_distributed_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` with ``dtype``: input, kernel and bias cast to the
    compute dtype at use (no-ops when the weights are kept in it); a
    ``QuantDense`` computes in its own dtype."""
    if isinstance(layer, QuantDense):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype, group) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product all-reduced over
    ``group`` (in f32), then the replicated bias added once."""
    if group is None:
        return dense(layer, x, dtype)
    if isinstance(layer, QuantDense):
        y = F.linear(x.to(layer.dtype), layer.w_q.to(layer.dtype))
        y = tp_lib.reduce_from_group(y, group) * layer.scale.to(y.dtype)
    else:
        y = tp_lib.reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


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
                 device, param_dtype: torch.dtype, attn_impl: str, quant: str = "",
                 local_heads: Optional[int] = None, group=None):
        super().__init__()
        self.n_heads = local_heads or n_heads     # this rank's heads
        self.head_dim = d_model // n_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.group = group
        width = self.n_heads * self.head_dim
        self.qkv = block_linear(quant, d_model, 3 * width, False, dtype, param_dtype, device)
        self.proj = block_linear(quant, width, d_model, False, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                flash_prefill: bool = False) -> torch.Tensor:
        B, L, _ = x.shape
        D = self.head_dim
        C = self.n_heads * D
        qkv = dense(self.qkv, tp_lib.copy_to_group(x, self.group), self.dtype)
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
        return row_dense(self.proj, out.reshape(B, L, C), self.dtype, self.group)

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
                 device, param_dtype: torch.dtype, attn_impl: str, quant: str = "",
                 local_heads: Optional[int] = None, local_ff: Optional[int] = None,
                 group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        ff = local_ff or 4 * d_model
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.attn = SelfAttention(d_model, n_heads, dtype, device, param_dtype,
                                  attn_impl, quant, local_heads, group)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.fc1 = block_linear(quant, d_model, ff, True, dtype, param_dtype, device)
        self.fc2 = block_linear(quant, ff, d_model, True, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                flash_prefill: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()), cache, flash_prefill)
        h = dense(self.fc1, tp_lib.copy_to_group(self.ln2(x.float()), self.group), self.dtype)
        return x + row_dense(self.fc2, F.gelu(h, approximate="tanh"), self.dtype, self.group)


class TransformerLM(nn.Module):
    """Next-token LM: ``forward(tokens [B, L]) -> f32 logits [B, L, vocab]``
    (``return_hidden``: the f32 ``[B, L, d_model]`` states before the head;
    under tensor parallelism the logits are this rank's ``[B, L, V/tp]``).

    With ``cache`` (from ``new_cache``) the call runs in decode mode and
    advances the caches in place; ``flash_prefill`` then sends a multi-token
    prompt at index 0 through the flash kernel.
    """

    def __init__(self, vocab_size: int = 32000, d_model: int = 512,
                 n_heads: int = 8, n_layers: int = 8, dtype=torch.float32,
                 device="cuda", param_dtype=None, attn_impl: str = "auto",
                 quant: str = "", mesh=None):
        super().__init__()
        device = resolve_device(device)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.quant = check_quant(quant)
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        # The constructor's arguments, to build a twin (models/quant.py).
        self.config = dict(vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
                           n_layers=n_layers, dtype=dtype, device=device,
                           param_dtype=param_dtype, attn_impl=attn_impl, quant=quant,
                           mesh=mesh)
        self.vocab_size = vocab_size
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.mesh = mesh
        self.tp = mesh.size("model") if mesh is not None else 1
        self.tp_rank = mesh.index("model") if mesh is not None else 0
        self.tp_group = mesh.group("model") if self.tp > 1 else None
        self.fsdp = None    # parallel/fsdp.py sets it
        self.specs = tp_lib.tp_specs(lm_shapes(vocab_size, d_model, n_layers, quant),
                                     n_heads, self.tp)
        vlo, vhi = tp_lib.split_range(vocab_size, self.tp, self.tp_rank)
        hlo, hhi = tp_lib.split_range(n_heads, self.tp, self.tp_rank)
        flo, fhi = tp_lib.split_range(4 * d_model, self.tp, self.tp_rank)
        self.vocab_lo = vlo
        self.local_heads = hhi - hlo
        self.embed = nn.Embedding(vhi - vlo, d_model, dtype=param_dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, dtype, device, param_dtype, attn_impl, quant,
                  hhi - hlo, fhi - flo, self.tp_group)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _param(self, name: str) -> torch.Tensor:
        """A top-level parameter as the forward uses it (gathered under
        FSDP)."""
        if self.fsdp is not None:
            return self.fsdp.full(name)
        return self.get_parameter(name)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[KVCache]] = None,
                flash_prefill: bool = False, return_hidden: bool = False) -> torch.Tensor:
        if cache is not None and len(cache) != len(self.blocks):
            raise ValueError(f"{len(cache)} caches for {len(self.blocks)} blocks")
        if self.fsdp is not None:
            with self.fsdp.saving():
                return self._forward(tokens, cache, flash_prefill, return_hidden)
        return self._forward(tokens, cache, flash_prefill, return_hidden)

    def _forward(self, tokens, cache, flash_prefill, return_hidden):
        x = self._embed(tokens).to(self.dtype)
        for i, blk in enumerate(self.blocks):
            c = None if cache is None else cache[i]
            if self.fsdp is not None:
                x = self.fsdp.call(blk, f"blocks.{i}.", x, c, flash_prefill)
            else:
                x = blk(x, c, flash_prefill)
        ln = {k: self._param(f"ln_f.{k}") for k in ("weight", "bias")}
        x = F.layer_norm(x.float(), x.shape[-1:], ln["weight"], ln["bias"], LN_EPS)
        if return_hidden:
            # The f32 pre-head hidden states, for the fused tied-head loss
            # (ops/fused_ce.py): the [B, L, vocab] logits never exist.
            return x
        # Tied head, multiplied in the module dtype like flax's embed.attend.
        e = (self.fsdp.full("embed.weight", self.dtype) if self.fsdp is not None
             else self.embed.weight.to(self.dtype))
        return (tp_lib.copy_to_group(x.to(self.dtype), self.tp_group) @ e.T).float()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The lookup (f32 rows); under tensor parallelism each rank looks
        up the tokens of its vocab rows and the rows are summed."""
        w = self._param("embed.weight")
        if self.tp_group is None:
            return F.embedding(tokens, w)
        local = tokens.long() - self.vocab_lo
        own = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w) * own[..., None]
        return tp_lib.reduce_from_group(rows, self.tp_group)

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Every rank's vocab shard of ``logits`` gathered to ``[..., V]``
        (``logits`` itself without tensor parallelism)."""
        if self.tp_group is None:
            return logits
        return tp_lib.gather_vocab(logits, self.specs["embed.weight"], self.tp_group)

    def new_cache(self, batch: int, max_len: int) -> List[KVCache]:
        """Zeroed per-layer caches at index 0 (this rank's heads)."""
        shape = (batch, max_len, self.local_heads, self.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return [KVCache(zeros(), zeros()) for _ in self.blocks]

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict, gathered over the FSDP and tensor
        groups (a collective; this rank's own tensors without a mesh)."""
        sd = self.state_dict()
        if self.fsdp is not None:
            sd = self.fsdp.gather(sd)
        return tp_lib.gather_state(sd, self.specs, self.tp_group)

    def shard_state_dict(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's part of a whole-model state dict (tensor shards, then
        FSDP shards)."""
        sd = tp_lib.shard_state(full, self.specs, self.tp_rank)
        return sd if self.fsdp is None else self.fsdp.shard(sd)

    @torch.no_grad()
    def load_full_state_dict(self, full: Dict[str, torch.Tensor]) -> "TransformerLM":
        self.load_state_dict(self.shard_state_dict(full))
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random init from ``generator`` with the flax defaults'
        distributions: Dense kernels lecun-normal (truncated at two standard
        deviations), the embedding normal with std 1/sqrt(d_model), biases
        zero, LayerNorm scale one.  A sharded model draws the whole model's
        weights and keeps its part."""
        if self.tp > 1 or self.fsdp is not None:
            full = TransformerLM(**{**self.config, "mesh": None})
            return self.load_full_state_dict(full.init_weights(generator).state_dict())
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


def lm_shapes(vocab_size: int, d_model: int, n_layers: int, quant: str = ""
              ) -> Dict[str, Tuple[int, ...]]:
    """The whole (unsharded) TransformerLM's parameter and buffer shapes by
    state-dict name, torch layouts."""
    C, F4 = d_model, 4 * d_model
    out: Dict[str, Tuple[int, ...]] = {"embed.weight": (vocab_size, C)}
    for i in range(n_layers):
        pre = f"blocks.{i}."
        dense_shapes = {"attn.qkv": (3 * C, C, False), "attn.proj": (C, C, False),
                        "fc1": (F4, C, True), "fc2": (C, F4, True)}
        for ln in ("ln1", "ln2"):
            out[f"{pre}{ln}.weight"] = out[f"{pre}{ln}.bias"] = (C,)
        for mod, (o, i_, bias) in dense_shapes.items():
            if quant:
                out[f"{pre}{mod}.w_q"] = (o, i_)
                out[f"{pre}{mod}.scale"] = (o,)
            else:
                out[f"{pre}{mod}.weight"] = (o, i_)
            if bias:
                out[f"{pre}{mod}.bias"] = (o,)
    out["ln_f.weight"] = out["ln_f.bias"] = (C,)
    return out
