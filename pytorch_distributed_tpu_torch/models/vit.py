"""Vision Transformer, the port of ``pytorch_distributed_tpu/models/vit.py``.

The JAX module's structure and names, not torchvision's:

- patchify is a reshape of the NHWC image into ``[N, L, p*p*C]`` rows and
  one ``Dense`` (``patch_embed``);
- a zero-initialised ``cls_token``, a grid-shaped ``pos_embedding``
  ``[1, gh, gw, D]`` and a separate ``cls_pos_embedding``, both
  ``normal(0.02)``; the grid is fixed by ``image_size`` at construction, and
  an image of another resolution or aspect raises (the JAX module's param
  shape error);
- pre-LN encoder blocks ``encoder_{i}``: f32 LayerNorm with flax's
  ``epsilon=1e-6``; flax ``MultiHeadDotProductAttention`` with per-head
  ``query`` / ``key`` / ``value`` kernels (stored here as ``[H, hd, D]``,
  ``[D, H, hd]`` in JAX) and an ``out`` kernel (``[D, H, hd]``, JAX ``[H,
  hd, D]``), the query scaled by ``1/sqrt(hd)`` in ``dtype``, the scores in
  ``dtype`` and the softmax and its product with the values in f32
  (``force_fp32_for_softmax``); an MLP with flax's ``nn.gelu``, the tanh
  approximation;
- ``remat``: each block under ``torch.utils.checkpoint`` (the JAX
  ``nn.remat``), the same function with less activation memory;
- a final f32 LayerNorm and an f32 ``head`` on the class token.

Attention is dense (scores, softmax, product), as the JAX module computes
it; no kernel of the port runs here.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_distributed_tpu_torch.models.layers import Dense, Dropout, ImageModel
from pytorch_distributed_tpu_torch.models.resnet import _lecun_normal_
from pytorch_distributed_tpu_torch.utils.device import resolve_device


class HeadProjection(nn.Module):
    """flax ``DenseGeneral(features=(H, hd))``: ``[B, L, D] -> [B, L, H, hd]``;
    ``weight [H, hd, D]``, ``bias [H, hd]``."""

    def __init__(self, d_model: int, heads: int, head_dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(heads, head_dim, d_model, **f32))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim, **f32))

    @property
    def fan_in(self) -> int:
        return self.weight.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, hd, D = self.weight.shape
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype).reshape(H * hd, D),
                     self.bias.to(self.dtype).reshape(H * hd))
        return y.unflatten(-1, (H, hd))


class OutProjection(nn.Module):
    """flax ``DenseGeneral(features=D, axis=(-2, -1))``: ``[B, L, H, hd] ->
    [B, L, D]``; ``weight [D, H, hd]``, ``bias [D]``."""

    def __init__(self, d_model: int, heads: int, head_dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(d_model, heads, head_dim, **f32))
        self.bias = nn.Parameter(torch.zeros(d_model, **f32))

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, o: torch.Tensor) -> torch.Tensor:
        return F.linear(o.to(self.dtype).flatten(-2), self.weight.to(self.dtype).flatten(1),
                        self.bias.to(self.dtype))


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, dtype, dropout_rate,
    force_fp32_for_softmax=True)`` on one input."""

    def __init__(self, d_model: int, heads: int, dropout: float, dtype, device):
        super().__init__()
        hd = d_model // heads
        self.dtype = dtype
        self.query = HeadProjection(d_model, heads, hd, dtype, device)
        self.key = HeadProjection(d_model, heads, hd, dtype, device)
        self.value = HeadProjection(d_model, heads, hd, dtype, device)
        self.out = OutProjection(d_model, heads, hd, dtype, device)
        # flax's broadcast_dropout: one [L, L] mask over batch and heads.
        self.attn_dropout = Dropout(dropout, broadcast_leading=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (m(x).transpose(1, 2) for m in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype)
        s = q @ k.transpose(-1, -2)                         # [B, H, L, L] in dtype
        a = torch.softmax(s.float(), dim=-1)                # f32
        if self.dtype == torch.float32:
            a = a.to(s.dtype)
        a = self.attn_dropout(a)
        o = a @ v.to(a.dtype)                               # f32 under bf16
        return self.out(o.transpose(1, 2))


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, heads: int, mlp_dim: int, dropout: float, dtype, device):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.ln_1 = nn.LayerNorm(d_model, eps=1e-6, **f32)
        self.self_attention = SelfAttention(d_model, heads, dropout, dtype, device)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-6, **f32)
        self.mlp_fc1 = Dense(d_model, mlp_dim, dtype, device)
        self.mlp_fc2 = Dense(mlp_dim, d_model, dtype, device)
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout1(self.self_attention(self.ln_1(x.float())))
        h = F.gelu(self.mlp_fc1(self.ln_2(x.float())), approximate="tanh")
        return x + self.dropout3(self.mlp_fc2(self.dropout2(h)))


class VisionTransformer(ImageModel):
    def __init__(self, patch_size: int = 16, d_model: int = 768, n_layers: int = 12,
                 n_heads: int = 12, mlp_dim: int = 3072, num_classes: int = 1000,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 remat: bool = False, image_size: int = 224, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch size "
                             f"{patch_size}")
        self.patch_size, self.d_model, self.n_layers = patch_size, d_model, n_layers
        self.dtype, self.remat = dtype, remat
        f32 = dict(dtype=torch.float32, device=device)
        g = image_size // patch_size
        self.patch_embed = Dense(patch_size * patch_size * 3, d_model, dtype, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model, **f32))
        self.pos_embedding = nn.Parameter(torch.empty(1, g, g, d_model, **f32))
        self.cls_pos_embedding = nn.Parameter(torch.empty(1, 1, d_model, **f32))
        self.dropout = Dropout(dropout)
        for i in range(n_layers):
            self.add_module(f"encoder_{i}",
                            EncoderBlock(d_model, n_heads, mlp_dim, dropout, dtype, device))
        self.ln_f = nn.LayerNorm(d_model, eps=1e-6, **f32)
        self.head = Dense(d_model, num_classes, torch.float32, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        super().init_weights(generator)
        for mod in self.modules():
            if isinstance(mod, (HeadProjection, OutProjection)):
                _lecun_normal_(mod.weight, mod.fan_in, generator)
                mod.bias.zero_()
        self.cls_token.zero_()
        for p in (self.pos_embedding, self.cls_pos_embedding):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        N, H, W, C = images.shape
        p, D = self.patch_size, self.d_model
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} not divisible by patch size {p}")
        gh, gw = H // p, W // p
        if (1, gh, gw, D) != tuple(self.pos_embedding.shape):
            raise ValueError(f"pos_embedding has shape {tuple(self.pos_embedding.shape)}; an "
                             f"{H}x{W} image needs shape {(1, gh, gw, D)}")
        x = (images.to(self.dtype).reshape(N, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(N, gh * gw, p * p * C))
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(N, 1, D).to(x.dtype), x], dim=1)
        pos = torch.cat([self.cls_pos_embedding, self.pos_embedding.reshape(1, gh * gw, D)],
                        dim=1)
        x = self.dropout(x + pos.to(x.dtype))
        for i in range(self.n_layers):
            block = getattr(self, f"encoder_{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.head(self.ln_f(x.float())[:, 0])


vit_b_16 = functools.partial(VisionTransformer, patch_size=16, d_model=768, n_layers=12,
                             n_heads=12, mlp_dim=3072)
vit_b_32 = functools.partial(VisionTransformer, patch_size=32, d_model=768, n_layers=12,
                             n_heads=12, mlp_dim=3072)
vit_l_16 = functools.partial(VisionTransformer, patch_size=16, d_model=1024, n_layers=24,
                             n_heads=16, mlp_dim=4096)
