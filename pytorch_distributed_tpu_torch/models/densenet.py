"""The DenseNet family, the port of ``pytorch_distributed_tpu/models/densenet.py``.

torchvision's configurations (densenet121/161/169/201) and names
(``features.conv0``, ``features.denseblock{b}.denselayer{l}.norm1`` ...,
``features.transition{b}``, ``features.norm5``, ``classifier``), NHWC with
the JAX module's pools: the stem's 3x3/s2 max pool padded by one with
``-inf``, each transition's 2x2/s2 average pool unpadded.  Each layer
concatenates its 32 (48) new channels onto its input, as the JAX module
does.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from pytorch_distributed_tpu_torch.models.layers import (
    Dense,
    ImageModel,
    MaxPool,
    avg_pool,
    norm,
    spatial_mean,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.device import resolve_device


class _DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, conv, device):
        super().__init__()
        self.norm1 = norm(in_ch, relu=True, device=device)
        self.conv1 = conv(in_ch, 4 * growth, 1)
        self.norm2 = norm(4 * growth, relu=True, device=device)
        self.conv2 = conv(4 * growth, growth, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return torch.cat([x, h], dim=-1)


class _Transition(nn.Module):
    """BN + ReLU, a 1x1 conv halving the channels, a 2x2/s2 average pool."""

    def __init__(self, in_ch: int, conv, device):
        super().__init__()
        self.norm = norm(in_ch, relu=True, device=device)
        self.conv = conv(in_ch, in_ch // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(self.norm(x)), 2, 2)


class DenseNet(ImageModel):
    def __init__(self, block_config: Sequence[int], growth: int = 32, init_features: int = 64,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        features = [("conv0", conv(3, init_features, 7, stride=2, padding=3)),
                    ("norm0", norm(init_features, relu=True, device=device)),
                    ("pool0", MaxPool(3, 2, ((1, 1), (1, 1))))]
        ch = init_features
        for b, layers in enumerate(block_config):
            block = nn.Sequential()
            for i in range(layers):
                block.add_module(f"denselayer{i + 1}", _DenseLayer(ch, growth, conv, device))
                ch += growth
            features.append((f"denseblock{b + 1}", block))
            if b != len(block_config) - 1:
                features.append((f"transition{b + 1}", _Transition(ch, conv, device)))
                ch //= 2
        features.append(("norm5", norm(ch, relu=True, device=device)))
        self.features = nn.Sequential()
        for name, mod in features:
            self.features.add_module(name, mod)
        self.classifier = Dense(ch, num_classes, torch.float32, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.classifier(spatial_mean(self.features(images.to(self.dtype))))


densenet121 = functools.partial(DenseNet, block_config=(6, 12, 24, 16))
densenet161 = functools.partial(DenseNet, block_config=(6, 12, 36, 24), growth=48,
                                init_features=96)
densenet169 = functools.partial(DenseNet, block_config=(6, 12, 32, 32))
densenet201 = functools.partial(DenseNet, block_config=(6, 12, 48, 32))
