"""Datasets, the port of ``pytorch_distributed_tpu/data/datasets.py``:
ImageFolder-compatible directory trees and synthetic data (numpy, so both
packages see the same samples).

``ImageFolder`` has the reference's dataset semantics
(``datasets.ImageFolder(traindir, transform)``, reference
distributed.py:163-175): one subdirectory per class, sorted class names →
contiguous label ids, (image, label) samples.  Files are decoded by
``data/imageio.py`` (by magic bytes, without PIL).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.data.imageio import read_image
from pytorch_distributed_tpu_torch.data.transforms import eval_transform_u8, train_transform_u8

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


class ImageFolder:
    def __init__(self, root: str, transform: Optional[Callable] = None,
                 native_decode: bool = False, image_size: int = 224,
                 native_augment: bool = True):
        """``native_decode=True``: samples come back as raw JPEG bytes plus
        crop-draw parameters, and the loader decodes the whole batch in the
        C++ data plane.  Train augmentation (``native_augment``) is the JAX
        plane's single-attempt RandomResizedCrop; eval is
        short-side-256/224·size + center crop.  Non-JPEG files (by
        extension, as in the JAX package) go through the u8 transform per
        sample."""
        self.root = root
        self.transform = transform
        self.native_decode = native_decode
        self.image_size = image_size
        self.native_augment = native_augment
        if native_decode:
            # Flip lives at the batch level (loader random_flip); the u8
            # stacks are flip-free.  Eval resize scales with the output size
            # (256/224), matching the native JPEG path.
            self._fallback_tf = (
                train_transform_u8(image_size) if native_augment
                else eval_transform_u8(image_size, resize=int(image_size * 256 / 224)))
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, f), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        """Fetch with an explicit augmentation RNG; the loader passes a
        ``(seed, epoch, index)``-keyed generator so augmentations differ per
        epoch yet stay reproducible."""
        path, label = self.samples[index]
        if rng is None:
            rng = np.random.default_rng(index)
        if self.native_decode:
            if path.lower().endswith((".jpg", ".jpeg")):
                with open(path, "rb") as f:
                    blob = f.read()
                params = None
                if self.native_augment:
                    params = np.array([rng.uniform(0.08, 1.0),
                                       rng.uniform(np.log(3 / 4), np.log(4 / 3)),
                                       rng.random(), rng.random()], np.float32)
                return ("jpeg", blob, params, label)
            return ("u8", np.asarray(self._fallback_tf(rng, read_image(path))), None, label)
        img = read_image(path)
        if self.transform is not None:
            img = np.asarray(self.transform(rng, img))
        else:
            img = np.asarray(img, dtype=np.float32) / 255.0
        # Preserve uint8 from the *_u8 stacks; everything else is f32.
        return (img if img.dtype == np.uint8 else img.astype(np.float32)), label

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        return self.get(index)


class SyntheticImageDataset:
    """Deterministic fake (image, label) pairs, ImageFolder-shaped: image
    ``[size, size, 3]`` from random bytes, label in ``[0, num_classes)``,
    both keyed by ``(seed, index)`` only (the same sample every epoch, like
    files on disk); ``rng`` drives the augmentation of ``transform``, if
    any, else the image is f32 in [0, 1)."""

    def __init__(self, length: int = 1280, num_classes: int = 1000, image_size: int = 224,
                 transform: Optional[Callable] = None, seed: int = 0):
        self.length = length
        self.num_classes = num_classes
        self.image_size = image_size
        self.transform = transform
        self.seed = seed
        self.classes = [f"class_{i:04d}" for i in range(num_classes)]

    def __len__(self) -> int:
        return self.length

    def get(self, index: int, rng: Optional[np.random.Generator] = None
            ) -> Tuple[np.ndarray, int]:
        content_rng = np.random.default_rng((self.seed, index))
        img = content_rng.integers(0, 256, size=(self.image_size, self.image_size, 3)
                                   ).astype(np.uint8)
        label = int(content_rng.integers(0, self.num_classes))
        if rng is None:
            rng = content_rng
        if self.transform is not None:
            out = np.asarray(self.transform(rng, img))
            return (out if out.dtype == np.uint8 else out.astype(np.float32)), label
        return img.astype(np.float32) / 255.0, label

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        return self.get(index)
