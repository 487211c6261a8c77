"""Host-side image transforms, the port of
``pytorch_distributed_tpu/data/transforms.py`` without PIL.

Capability parity with the reference's transform stacks:

- train: ``RandomResizedCrop(224) → RandomHorizontalFlip → ToTensor →
  Normalize(mean, std)`` (reference distributed.py:166-173)
- eval:  ``Resize(256) → CenterCrop(224) → ToTensor → Normalize``
  (reference distributed.py:182-189)

Output is NHWC float32 normalized, or uint8 from the ``*_u8`` stacks, as in
the JAX package.  Each transform is a callable ``(rng, image) -> image`` on
a uint8 ``[h, w, 3]`` array (f32 after ``ToArray``) with an explicit
``np.random.Generator``, drawn with the same calls in the same order as the
JAX transforms, so one seed gives the same crop and flip on both sides.

PIL's operations become: ``resize(..., BILINEAR)`` → ``native.resize_bilinear``
(PIL's own antialiased resample, bit for bit, in the C++ data plane);
``crop`` → ``crop`` below (zero outside the image, as PIL pads);
``transpose(FLIP_LEFT_RIGHT)`` → ``[:, ::-1]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pytorch_distributed_tpu_torch.data.native import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _rgb(img) -> np.ndarray:
    arr = np.asarray(img)
    return np.stack([arr] * 3, axis=-1) if arr.ndim == 2 else arr


def crop(img: np.ndarray, box) -> np.ndarray:
    """PIL's ``Image.crop((x0, y0, x1, y1))``: the box may reach outside the
    image, and what lies outside is zero."""
    x0, y0, x1, y1 = (int(v) for v in box)
    h, w = img.shape[:2]
    if 0 <= x0 and 0 <= y0 and x1 <= w and y1 <= h:
        return img[y0:y1, x0:x1]
    out = np.zeros((max(0, y1 - y0), max(0, x1 - x0)) + img.shape[2:], img.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, img):
        for t in self.transforms:
            img = t(rng, img)
        return img


class RandomResizedCrop:
    """Random area/aspect crop then resize: torchvision semantics (scale
    0.08-1.0, log-uniform aspect 3/4-4/3, 10 tries then center fallback)."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, rng: np.random.Generator, img):
        img = _rgb(img)
        h, w = img.shape[:2]
        area = w * h
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = int(rng.integers(0, w - cw + 1))
                y = int(rng.integers(0, h - ch + 1))
                return resize_bilinear(crop(img, (x, y, x + cw, y + ch)),
                                       (self.size, self.size))
        # Fallback: center crop of the constrained aspect.
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        x, y = (w - cw) // 2, (h - ch) // 2
        return resize_bilinear(crop(img, (x, y, x + cw, y + ch)), (self.size, self.size))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng: np.random.Generator, img):
        if rng.random() < self.p:
            img = _rgb(img)[:, ::-1]
        return img


class Resize:
    """Shorter side → ``size`` keeping aspect (torchvision Resize(int))."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng: np.random.Generator, img):
        img = _rgb(img)
        h, w = img.shape[:2]
        if w <= h:
            nw, nh = self.size, max(1, int(round(h * self.size / w)))
        else:
            nw, nh = max(1, int(round(w * self.size / h))), self.size
        return resize_bilinear(img, (nw, nh))


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng: np.random.Generator, img):
        img = _rgb(img)
        h, w = img.shape[:2]
        x = max(0, (w - self.size) // 2)
        y = max(0, (h - self.size) // 2)
        return crop(img, (x, y, x + self.size, y + self.size))


class ToArray:
    """uint8 → float32 NHWC in [0, 1] (torchvision ToTensor, minus the NCHW
    permute)."""

    def __call__(self, rng: np.random.Generator, img):
        return _rgb(np.asarray(img, dtype=np.float32) / 255.0)


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, rng: np.random.Generator, img):
        return (np.asarray(img, dtype=np.float32) - self.mean) / self.std


class ToU8:
    """uint8 HWC array (the u8-pipeline terminal: normalization and flip
    happen at batch level, in the C++ plane or on the device)."""

    def __call__(self, rng: np.random.Generator, img):
        return np.ascontiguousarray(_rgb(np.asarray(img, dtype=np.uint8)))


def train_transform(size: int = 224) -> Compose:
    """The reference's training stack (distributed.py:166-173)."""
    return Compose([RandomResizedCrop(size), RandomHorizontalFlip(), ToArray(), Normalize()])


def eval_transform(size: int = 224, resize: int = 256) -> Compose:
    """The reference's validation stack (distributed.py:182-189)."""
    return Compose([Resize(resize), CenterCrop(size), ToArray(), Normalize()])


def train_transform_u8(size: int = 224) -> Compose:
    """Training stack ending in uint8 (flip+normalize at batch level)."""
    return Compose([RandomResizedCrop(size), ToU8()])


def eval_transform_u8(size: int = 224, resize: int = 256) -> Compose:
    """Validation stack ending in uint8 (normalize at batch level)."""
    return Compose([Resize(resize), CenterCrop(size), ToU8()])
