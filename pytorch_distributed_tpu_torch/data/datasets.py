"""Synthetic image data, the port of ``SyntheticImageDataset`` in
``pytorch_distributed_tpu/data/datasets.py`` (numpy, so both packages see
the same samples).  ``ImageFolder`` is not ported yet: ROADMAP.md item A17.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticImageDataset:
    """Deterministic fake (image, label) pairs, ImageFolder-shaped: image
    ``[size, size, 3]`` f32 in [0, 1) from random bytes, label in
    ``[0, num_classes)``, both keyed by ``(seed, index)`` only: the same
    sample every epoch, like files on disk."""

    def __init__(self, length: int = 1280, num_classes: int = 1000, image_size: int = 224,
                 seed: int = 0):
        self.length = length
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed
        self.classes = [f"class_{i:04d}" for i in range(num_classes)]

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng((self.seed, index))
        img = rng.integers(0, 256, size=(self.image_size, self.image_size, 3)).astype(np.uint8)
        label = int(rng.integers(0, self.num_classes))
        return img.astype(np.float32) / 255.0, label
