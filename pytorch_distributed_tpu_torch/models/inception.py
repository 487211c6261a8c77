"""GoogLeNet and Inception-v3, the port of ``pytorch_distributed_tpu/models/inception.py``.

The JAX modules' names, which are torchvision's (``conv1.conv`` /
``conv1.bn``, ``inception3a.branch2.1.conv``, ``Mixed_5b.branch5x5_2.bn``,
``aux1.fc1``, ``AuxLogits.conv1``, ``fc``), and their arithmetic:

- ``BasicConv2d``: a bias-free conv, BatchNorm with ``eps=1e-3``, ReLU.
- GoogLeNet's ``ceil_mode`` max pools are built as the JAX module builds
  them: ``-inf`` padding of (0, 1) (the 3x3/s2 pools) or of the odd
  dimension (the 2x2/s2 pool), then a floor-mode pool.
- Inception-v3's branch average pools count the padding
  (``count_include_pad=True``); its aux head clamps the pool window to the
  feature map and pads its 5x5 conv to SAME below 5 pixels.
- Aux heads exist only with ``aux_logits`` and run only under
  ``capture_aux``, which returns ``(logits, aux)``; an ordinary forward
  returns the main logits and never touches them.
- torchvision's ``transform_input`` is not replicated (neither is it in
  JAX).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.layers import (
    Dense,
    Dropout,
    ImageModel,
    MaxPool,
    adaptive_avg_pool,
    avg_pool,
    max_pool,
    norm,
    spatial_mean,
)
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.device import resolve_device

_SAME1 = ((1, 1), (1, 1))


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + ReLU, both nets' unit cell."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, dtype=dtype,
                           device=device)
        self.bn = norm(out_ch, eps=1e-3, relu=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


def ceil_max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max pool with torch ``ceil_mode=True`` arithmetic (the JAX
    ``_ceil_max_pool``)."""
    return max_pool(x, 3, 2, ((0, 1), (0, 1)))


def ceil_max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max pool with ``ceil_mode=True`` (the JAX ``_ceil_max_pool2``):
    an odd dimension gets one ``-inf`` row or column."""
    return max_pool(x, 2, 2, ((0, x.shape[1] % 2), (0, x.shape[2] % 2)))


# ------------------------------------------------------------------ GoogLeNet
class Inception(nn.Module):
    """GoogLeNet's block: 1x1 / 1x1 -> 3x3 / 1x1 -> 3x3 / pool -> 1x1
    (torchvision's "5x5" branch is a 3x3, kept)."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, cp, conv):
        super().__init__()
        self.branch1 = conv(in_ch, c1, 1)
        self.branch2 = nn.Sequential(conv(in_ch, c3r, 1), conv(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(conv(in_ch, c5r, 1), conv(c5r, c5, 3, padding=1))
        self.branch4 = nn.Sequential(MaxPool(3, 1, _SAME1), conv(in_ch, cp, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)],
                         dim=-1)


class GoogLeNetAux(nn.Module):
    """Adaptive 4x4 average pool -> 1x1 conv 128 -> fc 1024 (f32) -> dropout
    0.7 -> fc."""

    def __init__(self, in_ch: int, num_classes: int, conv, device):
        super().__init__()
        self.conv = conv(in_ch, 128, 1)
        self.fc1 = Dense(128 * 4 * 4, 1024, torch.float32, device)
        self.dropout = Dropout(0.7)
        self.fc2 = Dense(1024, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(adaptive_avg_pool(x, 4))
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1).float()))
        return self.fc2(self.dropout(x))


class GoogLeNet(ImageModel):
    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.aux_logits = dtype, aux_logits
        conv = functools.partial(BasicConv2d, dtype=dtype, device=device)
        inc = functools.partial(Inception, conv=conv)
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.conv2 = conv(64, 64, 1)
        self.conv3 = conv(64, 192, 3, padding=1)
        self.inception3a = inc(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = inc(256, 128, 128, 192, 32, 96, 64)
        self.inception4a = inc(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = inc(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = inc(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = inc(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = inc(528, 256, 160, 320, 32, 128, 128)
        self.inception5a = inc(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = inc(832, 384, 192, 384, 48, 128, 128)
        if aux_logits:
            self.aux1 = GoogLeNetAux(512, num_classes, conv, device)
            self.aux2 = GoogLeNetAux(528, num_classes, conv, device)
        self.dropout = Dropout(0.2)
        self.fc = Dense(1024, num_classes, torch.float32, device)

    def forward(self, images: torch.Tensor, capture_aux: bool = False):
        want_aux = capture_aux and self.aux_logits
        x = ceil_max_pool(self.conv1(images.to(self.dtype)))
        x = ceil_max_pool(self.conv3(self.conv2(x)))
        x = ceil_max_pool(self.inception3b(self.inception3a(x)))
        x = self.inception4a(x)
        aux1 = self.aux1(x) if want_aux else None
        x = self.inception4d(self.inception4c(self.inception4b(x)))
        aux2 = self.aux2(x) if want_aux else None
        x = ceil_max_pool2(self.inception4e(x))
        x = self.inception5b(self.inception5a(x))
        logits = self.fc(self.dropout(spatial_mean(x)).float())
        return (logits, (aux1, aux2)) if want_aux else logits


# --------------------------------------------------------------- Inception v3
class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, conv):
        super().__init__()
        self.branch1x1 = conv(in_ch, 64, 1)
        self.branch5x5_1 = conv(in_ch, 48, 1)
        self.branch5x5_2 = conv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = conv(in_ch, 64, 1)
        self.branch3x3dbl_2 = conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = conv(96, 96, 3, padding=1)
        self.branch_pool = conv(in_ch, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, conv):
        super().__init__()
        self.branch3x3 = conv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = conv(in_ch, 64, 1)
        self.branch3x3dbl_2 = conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = conv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x, 3, 2)], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, conv):
        super().__init__()
        p71, p17 = (0, 3), (3, 0)  # 1x7, 7x1
        self.branch1x1 = conv(in_ch, 192, 1)
        self.branch7x7_1 = conv(in_ch, c7, 1)
        self.branch7x7_2 = conv(c7, c7, (1, 7), padding=p71)
        self.branch7x7_3 = conv(c7, 192, (7, 1), padding=p17)
        self.branch7x7dbl_1 = conv(in_ch, c7, 1)
        self.branch7x7dbl_2 = conv(c7, c7, (7, 1), padding=p17)
        self.branch7x7dbl_3 = conv(c7, c7, (1, 7), padding=p71)
        self.branch7x7dbl_4 = conv(c7, c7, (7, 1), padding=p17)
        self.branch7x7dbl_5 = conv(c7, 192, (1, 7), padding=p71)
        self.branch_pool = conv(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for k in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{k}")(bd)
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, conv):
        super().__init__()
        self.branch3x3_1 = conv(in_ch, 192, 1)
        self.branch3x3_2 = conv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = conv(in_ch, 192, 1)
        self.branch7x7x3_2 = conv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = conv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = conv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for k in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=-1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, conv):
        super().__init__()
        self.branch1x1 = conv(in_ch, 320, 1)
        self.branch3x3_1 = conv(in_ch, 384, 1)
        self.branch3x3_2a = conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = conv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = conv(in_ch, 448, 1)
        self.branch3x3dbl_2 = conv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = conv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = conv(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=-1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=-1)
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=-1)


class InceptionAux(nn.Module):
    """5x5/s3 average pool (window clamped to the map) -> 1x1 conv 128 ->
    5x5 conv 768 (VALID, SAME below 5 pixels) -> mean -> fc (f32)."""

    def __init__(self, in_ch: int, num_classes: int, conv, device):
        super().__init__()
        self.conv0 = conv(in_ch, 128, 1)
        self.conv1 = conv(128, 768, 5)
        self.fc = Dense(768, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(avg_pool(x, (min(5, x.shape[1]), min(5, x.shape[2])), 3))
        if min(x.shape[1:3]) < 5:
            x = F.pad(x, (0, 0, 2, 2, 2, 2))  # SAME for the 5x5 stride-1 conv
        return self.fc(spatial_mean(self.conv1(x)).float())


class InceptionV3(ImageModel):
    """Inception v3: 299x299 canonical, any size from 75 works (the head is
    a global mean)."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.aux_logits = dtype, aux_logits
        conv = functools.partial(BasicConv2d, dtype=dtype, device=device)
        self.Conv2d_1a_3x3 = conv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = conv(32, 32, 3)
        self.Conv2d_2b_3x3 = conv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = conv(64, 80, 1)
        self.Conv2d_4a_3x3 = conv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, conv)
        self.Mixed_5c = InceptionA(256, 64, conv)
        self.Mixed_5d = InceptionA(288, 64, conv)
        self.Mixed_6a = InceptionB(288, conv)
        self.Mixed_6b = InceptionC(768, 128, conv)
        self.Mixed_6c = InceptionC(768, 160, conv)
        self.Mixed_6d = InceptionC(768, 160, conv)
        self.Mixed_6e = InceptionC(768, 192, conv)
        if aux_logits:
            self.AuxLogits = InceptionAux(768, num_classes, conv, device)
        self.Mixed_7a = InceptionD(768, conv)
        self.Mixed_7b = InceptionE(1280, conv)
        self.Mixed_7c = InceptionE(2048, conv)
        self.dropout = Dropout(0.5)
        self.fc = Dense(2048, num_classes, torch.float32, device)

    def forward(self, images: torch.Tensor, capture_aux: bool = False):
        want_aux = capture_aux and self.aux_logits
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(images.to(self.dtype))))
        x = max_pool(x, 3, 2)
        x = max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        aux = self.AuxLogits(x) if want_aux else None
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        logits = self.fc(self.dropout(spatial_mean(x)).float())
        return (logits, aux) if want_aux else logits


googlenet = functools.partial(GoogLeNet)
inception_v3 = functools.partial(InceptionV3)
