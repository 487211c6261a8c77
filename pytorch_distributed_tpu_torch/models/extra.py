"""SqueezeNet, ShuffleNetV2 and MNASNet, the port of
``pytorch_distributed_tpu/models/extra.py``.

torchvision's configuration tables and names (SqueezeNet ``features.{i}``
with ``squeeze`` / ``expand1x1`` / ``expand3x3`` fires and ``classifier.1``;
ShuffleNetV2 ``conv1``, ``stage{2,3,4}.{i}.branch{1,2}.{k}``, ``conv5``,
``fc``; MNASNet ``layers.{i}`` and ``classifier.1``) with the JAX modules'
arithmetic: SqueezeNet's unpadded 3x3/s2 max pools and f32 conv
classifier, ShuffleNetV2's ``_channel_shuffle`` and split, depthwise convs
as ``groups`` = channels.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn

from pytorch_distributed_tpu_torch.models.layers import (
    Dense,
    Dropout,
    ImageModel,
    MaxPool,
    max_pool,
    norm,
    spatial_mean,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.device import resolve_device


# --------------------------------------------------------------- SqueezeNet
class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, e1: int, e3: int, conv):
        super().__init__()
        self.squeeze = conv(in_ch, squeeze, 1)
        self.expand1x1 = conv(squeeze, e1, 1)
        self.expand3x3 = conv(squeeze, e3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)), torch.relu(self.expand3x3(s))],
                         dim=-1)


# (squeeze, expand) of each fire, "M" a 3x3/s2 max pool, after the stem.
_SQUEEZE = {
    "1_0": ((96, 7), [(16, 64), (16, 64), (32, 128), "M", (32, 128), (48, 192), (48, 192),
                      (64, 256), "M", (64, 256)]),
    "1_1": ((64, 3), [(16, 64), (16, 64), "M", (32, 128), (32, 128), "M", (48, 192),
                      (48, 192), (64, 256), (64, 256)]),
}


class SqueezeNet(ImageModel):
    def __init__(self, version: str = "1_0", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device, bias=True)
        (stem, k), fires = _SQUEEZE[version]
        layers, ch = [conv(3, stem, k, stride=2), nn.ReLU(), MaxPool(3, 2)], stem
        for f in fires:
            if f == "M":
                layers.append(MaxPool(3, 2))
            else:
                layers.append(Fire(ch, f[0], f[1], f[1], conv))
                ch = 2 * f[1]
        self.features = nn.Sequential(*layers)
        # The classifier conv runs in f32, like every head of the zoo.
        self.classifier = nn.Sequential(
            Dropout(0.5), Conv2d(ch, num_classes, 1, dtype=torch.float32, device=device,
                                 bias=True), nn.ReLU())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return spatial_mean(self.classifier(self.features(images.to(self.dtype))))


# -------------------------------------------------------------- ShuffleNetV2
def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """The JAX ``_channel_shuffle`` on NHWC: channel ``g * C/groups + i``
    moves to ``i * groups + g``."""
    B, H, W, C = x.shape
    return x.reshape(B, H, W, groups, C // groups).transpose(3, 4).reshape(B, H, W, C)


class ShuffleUnit(nn.Module):
    """stride 1: split the channels, the second half through 1x1 -> 3x3
    depthwise -> 1x1; stride 2: both branches see the whole input."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, conv, device):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2

        def dw(ch: int):
            return conv(ch, ch, 3, stride=stride, padding=1, groups=ch)

        if stride > 1:
            self.branch1 = nn.Sequential(dw(in_ch), norm(in_ch, device=device),
                                         conv(in_ch, branch, 1), norm(branch, device=device),
                                         nn.ReLU())
        b_in = in_ch if stride > 1 else branch
        self.branch2 = nn.Sequential(conv(b_in, branch, 1), norm(branch, device=device),
                                     nn.ReLU(), dw(branch), norm(branch, device=device),
                                     conv(branch, branch, 1), norm(branch, device=device),
                                     nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            a, b = x.chunk(2, dim=-1)
            out = torch.cat([a, self.branch2(b.contiguous())], dim=-1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=-1)
        return channel_shuffle(out)


class ShuffleNetV2(ImageModel):
    def __init__(self, stage_out: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        self.conv1 = nn.Sequential(conv(3, 24, 3, stride=2, padding=1),
                                   norm(24, device=device), nn.ReLU())
        ch = 24
        for s, (out, repeats) in enumerate(zip(stage_out[:3], (4, 8, 4))):
            units = [ShuffleUnit(ch, out, 2, conv, device)]
            units += [ShuffleUnit(out, out, 1, conv, device) for _ in range(repeats - 1)]
            self.add_module(f"stage{s + 2}", nn.Sequential(*units))
            ch = out
        self.conv5 = nn.Sequential(conv(ch, stage_out[3], 1), norm(stage_out[3], device=device),
                                   nn.ReLU())
        self.fc = Dense(stage_out[3], num_classes, torch.float32, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv1(images.to(self.dtype))
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        x = self.stage4(self.stage3(self.stage2(x)))
        return self.fc(spatial_mean(self.conv5(x)))


# ------------------------------------------------------------------ MNASNet
class MBConv(nn.Module):
    """torchvision MNASNet's ``_InvertedResidual``: 1x1 expand, k x k
    depthwise, 1x1 project (no ReLU), residual at stride 1 and equal width."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int, kernel: int, conv,
                 device):
        super().__init__()
        hidden = in_ch * expand
        self.layers = nn.Sequential(
            conv(in_ch, hidden, 1), norm(hidden, device=device), nn.ReLU(),
            conv(hidden, hidden, kernel, stride=stride, padding=kernel // 2, groups=hidden),
            norm(hidden, device=device), nn.ReLU(),
            conv(hidden, out_ch, 1), norm(out_ch, device=device))
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers(x)
        return x + h if self.residual else h


def round_to_8(v: float) -> int:
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


# (expand, channels, repeats, stride, kernel): torchvision's MNASNet B1 table.
MNAS_SETTINGS: Tuple = ((3, 24, 3, 2, 3), (3, 40, 3, 2, 5), (6, 80, 3, 2, 5), (6, 96, 2, 1, 3),
                        (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))


class MNASNet(ImageModel):
    def __init__(self, alpha: float = 1.0, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        c32, c16 = round_to_8(32 * alpha), round_to_8(16 * alpha)
        layers = [conv(3, c32, 3, stride=2, padding=1), norm(c32, device=device), nn.ReLU(),
                  conv(c32, c32, 3, padding=1, groups=c32), norm(c32, device=device), nn.ReLU(),
                  conv(c32, c16, 1), norm(c16, device=device)]
        ch = c16
        for expand, c, repeats, stride, kernel in MNAS_SETTINGS:
            out = round_to_8(c * alpha)
            stack = [MBConv(ch, out, stride, expand, kernel, conv, device)]
            stack += [MBConv(out, out, 1, expand, kernel, conv, device)
                      for _ in range(repeats - 1)]
            layers.append(nn.Sequential(*stack))
            ch = out
        layers += [conv(ch, 1280, 1), norm(1280, device=device), nn.ReLU()]
        self.layers = nn.Sequential(*layers)
        self.classifier = nn.Sequential(Dropout(0.2),
                                        Dense(1280, num_classes, torch.float32, device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.classifier(spatial_mean(self.layers(images.to(self.dtype))))


squeezenet1_0 = functools.partial(SqueezeNet, "1_0")
squeezenet1_1 = functools.partial(SqueezeNet, "1_1")
shufflenet_v2_x0_5 = functools.partial(ShuffleNetV2, (48, 96, 192, 1024))
shufflenet_v2_x1_0 = functools.partial(ShuffleNetV2, (116, 232, 464, 1024))
shufflenet_v2_x1_5 = functools.partial(ShuffleNetV2, (176, 352, 704, 1024))
shufflenet_v2_x2_0 = functools.partial(ShuffleNetV2, (244, 488, 976, 2048))
mnasnet0_5 = functools.partial(MNASNet, 0.5)
mnasnet0_75 = functools.partial(MNASNet, 0.75)
mnasnet1_0 = functools.partial(MNASNet, 1.0)
mnasnet1_3 = functools.partial(MNASNet, 1.3)
