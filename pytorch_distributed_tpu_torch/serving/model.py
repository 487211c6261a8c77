"""Paged-attention twin of ``models/transformer.TransformerLM``.

Port of ``pytorch_distributed_tpu/serving/model.py``.  ``PagedTransformerLM``
keeps the parameter names of the port's ``TransformerLM`` (``embed``,
``blocks.{i}.{ln1,ln2}``, ``attn.{qkv,proj}``, ``fc1``/``fc2``, ``ln_f``,
the tied head), so ``utils/convert.py::lm_state_dict_from_jax`` and
``TransformerLM.state_dict()`` load into it unchanged.  Only the attention
inner changes: the per-call cache of ``SelfAttention._decode_attend``
becomes an explicit paged KV pool (serving/kvpool.py), because a serving
batch mixes sequences at different offsets and lifetimes — one scalar
cache index cannot describe it.  The pools are written in place.

Exactness contract, as the JAX module's: f32 scores ``/ sqrt(D)``, a
``-1e30`` mask ``kpos <= pos`` then softmax (masked lanes underflow to
exactly 0.0 in f32, so garbage KV reads contribute exactly nothing), the
same einsum contractions, f32 logits from the tied head.  ``rope_at`` is
``transformer.rope`` with the scalar offset generalised to a per-token
position matrix; the per-element float math is identical.  The model runs
in f32 (the JAX engine builds its model without a dtype); TF32 stays off,
torch's default for matmuls.  ``quant="int8"`` makes each block's ``qkv``,
``proj``, ``fc1`` and ``fc2`` a ``QuantDense`` (``models/quant.py``), as in
``TransformerLM``; its state dict is ``quantize_state_dict``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.quant import block_linear, check_quant
from pytorch_distributed_tpu_torch.models.transformer import LN_EPS, dense
from pytorch_distributed_tpu_torch.serving.kvpool import (
    lookup_blocks,
    paged_gather,
    paged_scatter,
)
from pytorch_distributed_tpu_torch.utils.device import resolve_device

F32 = torch.float32


def rope_at(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """``transformer.rope`` with explicit absolute positions.

    ``x [B, L, H, D]``, ``pos [B, L]`` (int).  Each (batch, token) lane
    gets the rotation for its own position — the vector-offset form a
    mixed-offset serving batch needs.  Elementwise math matches
    ``rope(x, offset=idx)`` at equal positions."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    ang = pos.to(F32)[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                       # [B, L, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class PagedSelfAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, block_size: int, device, quant: str = ""):
        super().__init__()
        self.n_heads = n_heads
        self.block_size = block_size
        self.qkv = block_linear(quant, d_model, 3 * d_model, False, F32, F32, device)
        self.proj = block_linear(quant, d_model, d_model, False, F32, F32, device)

    def forward(self, x, pool_k, pool_v, table, pos):
        B, L, C = x.shape
        D = C // self.n_heads
        qkv = dense(self.qkv, x, F32)
        q, k, v = (t.reshape(B, L, self.n_heads, D) for t in qkv.split(C, dim=-1))
        q = rope_at(q, pos)
        k = rope_at(k, pos)
        blk = lookup_blocks(table, pos, self.block_size)
        off = pos % self.block_size
        paged_scatter(pool_k, blk, off, k)
        paged_scatter(pool_v, blk, off, v)
        keys = paged_gather(pool_k, table)                    # [B, KV, H, D]
        values = paged_gather(pool_v, table)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) / (D ** 0.5)
        kpos = torch.arange(keys.shape[1], device=x.device)
        # self-inclusive causal mask over logical positions, per slot:
        # position j attends to committed positions 0..j.
        mask = kpos[None, None, None, :] <= pos[:, None, :, None]
        w = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, values.float()).reshape(B, L, C)
        return dense(self.proj, out, F32)


class PagedBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, block_size: int, device, quant: str = ""):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.attn = PagedSelfAttention(d_model, n_heads, block_size, device, quant)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.fc1 = block_linear(quant, d_model, 4 * d_model, True, F32, F32, device)
        self.fc2 = block_linear(quant, 4 * d_model, d_model, True, F32, F32, device)

    def forward(self, x, pool_k, pool_v, table, pos):
        x = x + self.attn(self.ln1(x), pool_k, pool_v, table, pos)
        h = dense(self.fc1, self.ln2(x), F32)
        return x + dense(self.fc2, F.gelu(h, approximate="tanh"), F32)


class PagedTransformerLM(nn.Module):
    """``forward(tokens [B, L], pool_k, pool_v, table [B, W], pos [B, L])
    -> f32 logits [B, L, vocab]``, writing the new tokens' k/v into
    ``pool_k``/``pool_v`` ``[n_layers, NB, BS, H, D]`` in place.

    Pools are explicit state, not module buffers: the engine owns them, so
    one captured decode step serves every sequence the pool will ever
    hold.  ``table``, ``pos`` and ``tokens`` are int64."""

    def __init__(self, vocab_size: int = 64, d_model: int = 32, n_heads: int = 4,
                 n_layers: int = 1, block_size: int = 16, quant: str = "", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        check_quant(quant)
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        self.blocks = nn.ModuleList(
            PagedBlock(d_model, n_heads, block_size, device, quant) for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, tokens, pool_k, pool_v, table, pos):
        x = self.embed(tokens)
        for i, blk in enumerate(self.blocks):
            x = blk(x, pool_k[i], pool_v[i], table, pos)
        return self.ln_f(x) @ self.embed.weight.T
