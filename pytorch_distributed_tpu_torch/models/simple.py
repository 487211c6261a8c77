"""AlexNet and the VGG family, the port of ``pytorch_distributed_tpu/models/simple.py``.

torchvision's stage and channel tables and its parameter names
(``features.{i}``, ``classifier.{i}``) with the JAX modules' choices: NHWC,
f32 parameters and ``dtype`` compute, biased convs, dropout where the JAX
module has it, the classifier's last layer in f32.  The flatten after the
adaptive average pool is NHWC's order (the JAX Dense kernels' row order).
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import torch
from torch import nn

from pytorch_distributed_tpu_torch.models.layers import (
    Dense,
    Dropout,
    ImageModel,
    MaxPool,
    adaptive_avg_pool,
    norm,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.device import resolve_device


class AlexNet(ImageModel):
    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device, bias=True)
        self.features = nn.Sequential(
            conv(3, 64, 11, stride=4, padding=2), nn.ReLU(), MaxPool(3, 2),
            conv(64, 192, 5, padding=2), nn.ReLU(), MaxPool(3, 2),
            conv(192, 384, 3, padding=1), nn.ReLU(),
            conv(384, 256, 3, padding=1), nn.ReLU(),
            conv(256, 256, 3, padding=1), nn.ReLU(), MaxPool(3, 2))
        self.classifier = nn.Sequential(
            Dropout(0.5), Dense(256 * 6 * 6, 4096, dtype, device), nn.ReLU(),
            Dropout(0.5), Dense(4096, 4096, dtype, device), nn.ReLU(),
            Dense(4096, num_classes, torch.float32, device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool(self.features(images.to(self.dtype)), 6)
        return self.classifier(x.reshape(x.shape[0], -1))


VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

PLAIN_VGG_SYNC_BN = ("bn_axis_name (--sync-bn) on a plain VGG: this variant has no BatchNorm "
                     "layers to synchronize — use the *_bn arch or drop the flag")


class VGG(ImageModel):
    """VGG of ``cfg`` (``"M"``: a 2x2 max pool); ``batch_norm`` adds a
    BatchNorm after each conv."""

    def __init__(self, cfg: Sequence[Union[int, str]], batch_norm: bool = False,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.batch_norm = dtype, batch_norm
        conv = functools.partial(Conv2d, dtype=dtype, device=device, bias=True)
        layers, ch = [], 3
        for v in cfg:
            if v == "M":
                layers.append(MaxPool(2, 2))
                continue
            layers.append(conv(ch, int(v), 3, padding=1))
            if batch_norm:
                layers.append(norm(int(v), device=device))
            layers.append(nn.ReLU())
            ch = int(v)
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Dense(ch * 7 * 7, 4096, dtype, device), nn.ReLU(), Dropout(0.5),
            Dense(4096, 4096, dtype, device), nn.ReLU(), Dropout(0.5),
            Dense(4096, num_classes, torch.float32, device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool(self.features(images.to(self.dtype)), 7)
        return self.classifier(x.reshape(x.shape[0], -1))


alexnet = functools.partial(AlexNet)
vgg11 = functools.partial(VGG, cfg=VGG_CFGS["A"])
vgg13 = functools.partial(VGG, cfg=VGG_CFGS["B"])
vgg16 = functools.partial(VGG, cfg=VGG_CFGS["D"])
vgg19 = functools.partial(VGG, cfg=VGG_CFGS["E"])
vgg11_bn = functools.partial(VGG, cfg=VGG_CFGS["A"], batch_norm=True)
vgg13_bn = functools.partial(VGG, cfg=VGG_CFGS["B"], batch_norm=True)
vgg16_bn = functools.partial(VGG, cfg=VGG_CFGS["D"], batch_norm=True)
vgg19_bn = functools.partial(VGG, cfg=VGG_CFGS["E"], batch_norm=True)
