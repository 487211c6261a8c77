"""ResNet family, the port of ``pytorch_distributed_tpu/models/resnet.py``.

The torchvision zoo's block, stage and width structure (resnet18-152, the
wide and ResNeXt variants) with the JAX model's choices:

- NHWC activations at the public boundary (images ``[N, H, W, 3]``); inside,
  each conv sees its NHWC tensor as a channels-last NCHW view, the same
  memory, so ``F.conv2d`` and the fused kernels read the same bytes.
- f32 parameters, ``dtype`` compute: each conv casts its weight at use; the
  BatchNorm statistics accumulate in f32 (``ops/fused_bn.py``); the
  classifier runs in f32.
- Parameter names are torchvision's (``conv1``, ``bn1``,
  ``layer{s}.{i}.conv{k}`` / ``bn{k}``, ``downsample.0/1``, ``fc``), so
  ``utils/convert.py`` carries JAX weights in and the JAX package's
  ``import_resnet_state_dict`` reads this ``state_dict`` back.
- ``fused_convbn``: the stride-1 conv -> BN pairs of a block go through
  ``ops/fused_conv_bn.conv_bn``, whose backward is the K4 (1x1) or K5 (3x3)
  kernel; the parameters are the same modules' either way.
- Init (``init_weights``) from an explicit ``torch.Generator``: lecun-normal
  convs and classifier (truncated at two standard deviations, flax's
  default), zero biases, BN scale one except the last BN of each block,
  which starts at zero.

``set_bn_group(group)`` threads a ``torch.distributed`` process group into
every BatchNorm (fused or not): training-mode statistics then cover the
global batch of its ranks: the JAX GSPMD step's BatchNorm, and under
explicit collectives the ``--sync-bn`` flag (the JAX ``bn_axis_name``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops.fused_bn import FusedBatchNormAct
from pytorch_distributed_tpu_torch.ops.fused_conv_bn import conv2d_nhwc, conv_bn
from pytorch_distributed_tpu_torch.utils.device import resolve_device

# flax's lecun_normal: variance 1/fan_in of a normal truncated at +-2 std,
# rescaled by this constant so the truncated draw keeps that variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    t = torch.empty(w.shape, device=w.device)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    w.copy_(t)


class Conv2d(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=dtype)`` over NHWC: an f32 OIHW
    weight cast to ``dtype`` at use, symmetric padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size,
            dtype=torch.float32, device=device))

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x.to(self.dtype), self.weight.to(self.dtype), self.stride,
                           self.padding, self.groups)


def _fuse_ok(fused: bool, conv: Callable, norm: Callable) -> bool:
    """The shared fold gate: only the stock ``Conv2d`` / ``FusedBatchNormAct``
    may be replaced by the fused ops; a custom factory (or a partial carrying
    settings the fused op would not honour) keeps the unfused composition."""
    if not fused:
        return False
    if getattr(norm, "func", norm) is not FusedBatchNormAct:
        return False
    if getattr(conv, "func", conv) is not Conv2d:
        return False
    if set(getattr(conv, "keywords", {})) - {"dtype", "device"}:
        return False
    return not (set(getattr(norm, "keywords", {})) - {"momentum", "eps", "device"})


def _downsample(conv, norm, in_ch: int, out_ch: int, strides: int) -> Optional[nn.Sequential]:
    if strides == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(conv(in_ch, out_ch, 1, stride=strides), norm(out_ch))


class BasicBlock(nn.Module):
    """Two 3x3 convs.  Fused: both mains fold through K5 when stride 1 (the
    second always), a stride-1 downsample through K4; strided slots keep the
    unfused backward."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1, groups: int = 1,
                 base_width: int = 64, conv: Callable = Conv2d,
                 norm: Callable = FusedBatchNormAct, fused_convbn: bool = False):
        super().__init__()
        self.strides = strides
        self.out_channels = filters * self.expansion
        self.conv1 = conv(in_ch, filters, 3, stride=strides, padding=1)
        self.bn1 = norm(filters, relu=True)
        self.conv2 = conv(filters, filters, 3, padding=1)
        self.bn2 = norm(filters, zero_init=True)
        self.downsample = _downsample(conv, norm, in_ch, self.out_channels, strides)
        self.fused = _fuse_ok(fused_convbn, conv, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if not self.fused:
            y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
            if self.downsample is not None:
                residual = self.downsample(x)
            return torch.relu(y + residual)
        if self.strides == 1:
            y = conv_bn(self.conv1, self.bn1, x)
        else:
            y = self.bn1(self.conv1(x))
        y = conv_bn(self.conv2, self.bn2, y)
        if self.downsample is not None:
            dconv, dbn = self.downsample
            residual = conv_bn(dconv, dbn, x) if self.strides == 1 else dbn(dconv(x))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, groups) -> 1x1.  Fused: both 1x1 pairs fold
    through K4, the middle 3x3 through K5 when stride 1 and ungrouped, a
    stride-1 downsample through K4; strided slots keep the unfused
    backward."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1, groups: int = 1,
                 base_width: int = 64, conv: Callable = Conv2d,
                 norm: Callable = FusedBatchNormAct, fused_convbn: bool = False):
        super().__init__()
        self.strides, self.groups = strides, groups
        width = int(filters * (base_width / 64.0)) * groups
        self.out_channels = filters * self.expansion
        self.conv1 = conv(in_ch, width, 1)
        self.bn1 = norm(width, relu=True)
        self.conv2 = conv(width, width, 3, stride=strides, padding=1, groups=groups)
        self.bn2 = norm(width, relu=True)
        self.conv3 = conv(width, self.out_channels, 1)
        # Zero-init the last BN scale so blocks start as identity.
        self.bn3 = norm(self.out_channels, zero_init=True)
        self.downsample = _downsample(conv, norm, in_ch, self.out_channels, strides)
        self.fused = _fuse_ok(fused_convbn, conv, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if not self.fused:
            y = self.bn1(self.conv1(x))
            y = self.bn2(self.conv2(y))
            y = self.bn3(self.conv3(y))
            if self.downsample is not None:
                residual = self.downsample(x)
            return torch.relu(y + residual)
        y = conv_bn(self.conv1, self.bn1, x)
        if self.strides == 1 and self.groups == 1:
            y = conv_bn(self.conv2, self.bn2, y)
        else:
            y = self.bn2(self.conv2(y))
        y = conv_bn(self.conv3, self.bn3, y)
        if self.downsample is not None:
            dconv, dbn = self.downsample
            residual = conv_bn(dconv, dbn, x) if self.strides == 1 else dbn(dconv(x))
        return torch.relu(y + residual)


class _SpaceToDepthStem(nn.Module):
    """The 7x7/s2/p3 stem computed as a 4x4/s1 conv on 2x2 space-to-depth
    packed input; the same parameter (``weight`` [features, C, 7, 7]) and the
    same function as the conv7 stem, for even spatial sizes."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 7, 7,
                                               dtype=torch.float32, device=device))

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, C = x.shape
        if H % 2 or W % 2:
            raise ValueError(f"space_to_depth stem needs even spatial dims, got {H}x{W}")
        F_ = self.weight.shape[0]
        # Output row h' of the s2/p3 7x7 conv reads input rows 2h'-3..2h'+3;
        # based at 2h'-4 that is an 8x8 kernel whose first row and column
        # are zero.  Packed channel (dh * 2 + dw) * C + c holds pixel
        # (2i + dh, 2j + dw), channel c.
        w8 = F.pad(self.weight, (1, 0, 1, 0))                       # [F, C, 8, 8]
        wp = (w8.reshape(F_, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
              .reshape(F_, 4 * C, 4, 4))
        xp = (x.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
              .reshape(N, H // 2, W // 2, 4 * C))
        xp = F.pad(xp.to(self.dtype), (0, 0, 2, 1, 2, 1))
        return conv2d_nhwc(xp, wp.to(self.dtype))


class ResNet(nn.Module):
    """ResNet over NHWC images; returns f32 logits ``[N, num_classes]``.

    Built on ``device`` (default: the card; raises without one) with f32
    parameters, computing in ``dtype``; call ``init_weights`` before use.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, groups: int = 1, base_width: int = 64,
                 dtype: torch.dtype = torch.float32, stem: str = "conv7",
                 fused_convbn: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        norm = functools.partial(FusedBatchNormAct, momentum=0.9, eps=1e-5, device=device)
        if stem == "space_to_depth":
            self.conv1 = _SpaceToDepthStem(3, num_filters, dtype, device)
        elif stem == "conv7":
            self.conv1 = conv(3, num_filters, 7, stride=2, padding=3)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.bn1 = norm(num_filters, relu=True)
        ch = num_filters
        for i, block_count in enumerate(stage_sizes):
            blocks = []
            for j in range(block_count):
                blocks.append(block_cls(ch, num_filters * 2 ** i,
                                        strides=2 if i > 0 and j == 0 else 1,
                                        groups=groups, base_width=base_width, conv=conv,
                                        norm=norm, fused_convbn=fused_convbn))
                ch = blocks[-1].out_channels
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(ch, num_classes, dtype=torch.float32, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """Random init from ``generator`` with the JAX model's distributions."""
        for mod in self.modules():
            if isinstance(mod, (Conv2d, _SpaceToDepthStem)):
                _lecun_normal_(mod.weight, mod.fan_in, generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, FusedBatchNormAct):
                mod.reset_parameters()
        return self

    def set_bn_group(self, group) -> "ResNet":
        """Normalise every BatchNorm over ``group``'s global batch (None:
        this process's batch)."""
        for mod in self.modules():
            if isinstance(mod, FusedBatchNormAct):
                mod.group = group
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(images.to(self.dtype)))
        # Max-pool pads with -inf, as flax's nn.max_pool does.
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        x = x.permute(0, 2, 3, 1).contiguous()
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)  # global average pool
        return self.fc(x.float())


# Stage configurations mirror torchvision's resnet table.
resnet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
resnet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
resnet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
resnet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck)
resnet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck)
wide_resnet50_2 = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck, base_width=128)
wide_resnet101_2 = functools.partial(
    ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck, base_width=128)
resnext50_32x4d = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck, groups=32, base_width=4)
resnext101_32x8d = functools.partial(
    ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck, groups=32, base_width=8)
