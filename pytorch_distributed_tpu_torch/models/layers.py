"""Layers the image zoo shares: the port of the flax pieces the JAX zoo
(``pytorch_distributed_tpu/models/{simple,densenet,mobilenet,extra,
inception,vit}.py``) builds its models from.

- ``Dense``: flax ``nn.Dense(dtype=dtype)``, an f32 ``[out, in]`` weight
  and bias cast to ``dtype`` at use (torch ``Linear``'s names and layout).
- NHWC pools with flax's arithmetic: ``max_pool`` pads with ``-inf`` (any
  padding, asymmetric included), ``avg_pool`` counts the padding
  (``count_include_pad``, flax's default), ``adaptive_avg_pool`` has
  torch's bin edges (the JAX ``_adaptive_avg_pool``), ``spatial_mean`` is
  ``jnp.mean`` over H and W (f32 accumulation, the input's dtype out).
- ``Dropout``: flax ``nn.Dropout`` (keep with probability ``1 - p``, kept
  values scaled by ``1 / (1 - p)``), its mask drawn with ``bernoulli_``
  from a ``torch.Generator`` seeded by the ``DropoutKey`` the train step
  sets (``set_dropout_key``), never from the global RNG: a function of
  ``(seed, step, microbatch[, rank])`` and the layer, so a resumed run
  draws the masks an uninterrupted one would.  Under the GSPMD twin the
  key draws the global batch's mask and keeps this rank's rows, so a
  sample's mask depends on its place in the global batch, not on the
  world size.
- ``ImageModel``: the zoo's base, with the JAX modules' init
  (``init_weights``: flax's lecun-normal for conv and dense kernels, zero
  biases, BatchNorm and LayerNorm at one and zero) and ``set_bn_group``
  (global-batch statistics for every ``FusedBatchNormAct``, as
  ``ResNet.set_bn_group``).

Activations are NHWC at every boundary; a pool sees its tensor as a
channels-last NCHW view of the same memory.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.resnet import Conv2d, _lecun_normal_
from pytorch_distributed_tpu_torch.ops.fused_bn import FusedBatchNormAct

Pad = Tuple[Tuple[int, int], Tuple[int, int]]
_NO_PAD: Pad = ((0, 0), (0, 0))


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype)``: ``x @ W.T + b`` in ``dtype``
    from f32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **f32))
        self.bias = nn.Parameter(torch.zeros(out_features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool(x: torch.Tensor, window: Union[int, Sequence[int]], stride: Union[int, Sequence[int]],
             padding: Pad = _NO_PAD) -> torch.Tensor:
    """flax ``nn.max_pool(x, window, stride, padding)`` on NHWC: the padding
    (``((top, bottom), (left, right))``) holds ``-inf``, so it never wins."""
    (pt, pb), (pl, pr) = padding
    kh, kw = (window, window) if isinstance(window, int) else window
    if pt == pb <= kh // 2 and pl == pr <= kw // 2:
        # torch's own padding is -inf and symmetric.
        return _nhwc(F.max_pool2d(_nchw(x), (kh, kw), stride, padding=(pt, pl)))
    x = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), (kh, kw), stride))


def avg_pool(x: torch.Tensor, window: Union[int, Sequence[int]], stride: Union[int, Sequence[int]],
             padding: int = 0) -> torch.Tensor:
    """flax ``nn.avg_pool`` on NHWC, symmetric ``padding`` counted in the
    window (``count_include_pad=True``)."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride, padding=padding,
                              count_include_pad=True))


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """The JAX ``_adaptive_avg_pool``: torch ``AdaptiveAvgPool2d`` bins (row
    bin i averages rows ``[floor(iH/out), ceil((i+1)H/out))``) on NHWC."""
    if x.shape[1] == out and x.shape[2] == out:
        return x
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), out))


class MaxPool(nn.Module):
    """``max_pool`` as a module (for the zoo's ``nn.Sequential`` stacks)."""

    def __init__(self, window, stride, padding: Pad = _NO_PAD):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.window, self.stride, self.padding)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))``: f32 accumulation, x's dtype out."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


# ----------------------------------------------------------------- dropout

_MASK64 = (1 << 64) - 1


def _splitmix(h: int) -> int:
    h = (h + 0x9E3779B97F4A7C15) & _MASK64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
    return h ^ (h >> 31)


def mix_seed(*values: int) -> int:
    """A 63-bit generator seed from integers (the role of JAX's ``fold_in``
    chain): splitmix64 over each value in turn."""
    h = 0
    for v in values:
        h = _splitmix(h ^ (int(v) & _MASK64))
    return h >> 1


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Which masks a training forward draws: the run's ``seed``, the global
    ``step`` and the ``micro``-batch index (the JAX ``fold_in(base_key,
    step)`` and ``fold_in(rng, i)``).  ``per_rank`` (the explicit step, the
    JAX ``fold_in(..., axis_index)``): ``rank`` enters the seed and the
    draw is this rank's batch alone.  Otherwise (the GSPMD twin) the draw
    covers the ``world`` ranks' batch, whose row ``j * world + rank`` is
    this rank's row j (the samplers stride the global batch over the
    ranks), and this rank keeps its rows."""

    seed: int
    step: int
    micro: int = 0
    rank: int = 0
    world: int = 1
    per_rank: bool = False

    def keep_mask(self, layer: int, shape: Sequence[int], keep: float,
                  device: torch.device, batch_shared: bool = False) -> torch.Tensor:
        """The boolean keep mask of dropout layer ``layer`` for an input of
        ``shape`` (this rank's rows).  ``batch_shared``: one mask broadcast
        over the batch (``shape[0]`` is 1), the same on every rank of the
        GSPMD twin."""
        stream = self.rank if self.per_rank else -1
        g = torch.Generator(device=device)
        g.manual_seed(mix_seed(self.seed, self.step, self.micro, stream, layer))
        world = 1 if self.per_rank or batch_shared else self.world
        full = torch.empty((shape[0] * world, *shape[1:]), device=device)
        full.bernoulli_(keep, generator=g)
        if world > 1:
            full = full.view(shape[0], world, *shape[1:])[:, self.rank]
        return full.bool()


class Dropout(nn.Module):
    """flax ``nn.Dropout(p)``: identity in eval mode; in training mode the
    key set by ``set_dropout_key`` draws the mask (none set: an error).
    ``broadcast_leading`` dims of the mask are 1 (flax attention's
    ``broadcast_dropout`` over batch and heads)."""

    def __init__(self, p: float, broadcast_leading: int = 0):
        super().__init__()
        self.p = p
        self.broadcast_leading = broadcast_leading
        self.key: Optional[DropoutKey] = None
        self.index = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.key is None:
            raise RuntimeError("dropout in training mode needs a DropoutKey: the train step "
                               "sets one (models.layers.set_dropout_key)")
        keep = 1.0 - self.p
        lead = self.broadcast_leading
        shape = (1,) * lead + tuple(x.shape[lead:])
        mask = self.key.keep_mask(self.index, shape, keep, x.device, batch_shared=lead > 0)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_layers(model: nn.Module) -> List[Dropout]:
    """The model's ``Dropout`` modules in registration order."""
    return [m for m in model.modules() if isinstance(m, Dropout)]


def set_dropout_key(layers: Sequence[Dropout], key: Optional[DropoutKey]) -> None:
    """Give each dropout layer ``key`` and its index (its own stream)."""
    for i, m in enumerate(layers):
        m.key, m.index = key, i


# ------------------------------------------------------------------- models

def norm(features: int, eps: float = 1e-5, relu: bool = False, device=None
         ) -> FusedBatchNormAct:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=eps)`` (+ ReLU)."""
    return FusedBatchNormAct(features, momentum=0.9, eps=eps, relu=relu, device=device)


class ImageModel(nn.Module):
    """Base of the zoo's models: NHWC images in, f32 logits out."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ImageModel":
        """Random init from ``generator`` with the JAX modules' initializers:
        lecun-normal conv and dense kernels (truncated at two standard
        deviations), zero biases, norms at one and zero."""
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                _lecun_normal_(mod.weight, mod.fan_in, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Dense):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, (FusedBatchNormAct, nn.LayerNorm)):
                mod.reset_parameters()
        return self

    def set_bn_group(self, group) -> "ImageModel":
        """Normalise every BatchNorm over ``group``'s global batch (None:
        this process's batch)."""
        for mod in self.modules():
            if isinstance(mod, FusedBatchNormAct):
                mod.group = group
        return self

