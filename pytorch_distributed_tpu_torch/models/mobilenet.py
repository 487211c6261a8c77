"""MobileNetV2, the port of ``pytorch_distributed_tpu/models/mobilenet.py``.

torchvision's inverted-residual table, width rounding and names
(``features.0.0`` / ``.1``, ``features.{i}.conv.{k}``, ``features.18``,
``classifier.1``): ReLU6 after the expansion and the depthwise conv
(``groups`` = channels), none after the projection, the residual where the
stride is 1 and the width stays.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from pytorch_distributed_tpu_torch.models.layers import (
    Dense,
    Dropout,
    ImageModel,
    norm,
    spatial_mean,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn_relu6(conv, device, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                   groups: int = 1) -> nn.Sequential:
    return nn.Sequential(conv(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                              groups=groups),
                         norm(out_ch, device=device), nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int, conv, device):
        super().__init__()
        hidden = in_ch * expand
        layers = [] if expand == 1 else [_conv_bn_relu6(conv, device, in_ch, hidden, 1)]
        layers += [_conv_bn_relu6(conv, device, hidden, hidden, 3, stride, groups=hidden),
                   conv(hidden, out_ch, 1), norm(out_ch, device=device)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return x + h if self.residual else h


# (expand, channels, repeats, stride): torchvision's mobilenet_v2 table.
SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
            (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(ImageModel):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        ch = make_divisible(32 * width_mult)
        layers = [_conv_bn_relu6(conv, device, 3, ch, 3, 2)]
        for expand, c, reps, s in SETTINGS:
            out = make_divisible(c * width_mult)
            for i in range(reps):
                layers.append(InvertedResidual(ch, out, s if i == 0 else 1, expand, conv,
                                               device))
                ch = out
        last = make_divisible(1280 * max(1.0, width_mult))
        layers.append(_conv_bn_relu6(conv, device, ch, last, 1))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(Dropout(0.2),
                                        Dense(last, num_classes, torch.float32, device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.classifier(spatial_mean(self.features(images.to(self.dtype))))


mobilenet_v2 = functools.partial(MobileNetV2)
