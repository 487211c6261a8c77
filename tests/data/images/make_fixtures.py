"""Write the image fixtures of this directory (run from the repo root):

    python tests/data/images/make_fixtures.py

Synthetic ImageNet-like photographs (smooth gradients, solid shapes, a
little noise), seeded, at ImageNet's common sizes, written with PIL at its
default JPEG quality: five RGB JPEGs, one grayscale and one CMYK JPEG, and
one PNG saved under a ``.JPEG`` name (ImageNet's train set has such a
file); plus a lossless PNG twin of each RGB JPEG's pixels, for hosts whose
C++ data plane has no libjpeg.  ``chip_smoke.py`` links them into an
ImageFolder tree; the CPU tests write their own images.
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, width, height, PIL mode, format)
FIXTURES = (
    ("rgb0", 500, 375, "RGB", "JPEG"),
    ("rgb1", 375, 500, "RGB", "JPEG"),
    ("rgb2", 333, 500, "RGB", "JPEG"),
    ("rgb3", 640, 480, "RGB", "JPEG"),
    ("rgb4", 500, 333, "RGB", "JPEG"),
    ("gray5", 500, 375, "L", "JPEG"),
    ("cmyk6", 375, 500, "CMYK", "JPEG"),
    ("png7", 500, 375, "RGB", "PNG"),
)


def picture(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """uint8 [h, w, 3]: per-channel gradients, a few ellipses and
    rectangles of solid colour, Gaussian noise of sigma 0.7."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        ax, ay, ph = rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(0, 2 * np.pi)
        img[..., c] = 128 + 90 * np.sin(ph + 3 * (ax * x / w + ay * y / h))
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        rx, ry = rng.uniform(0.05, 0.25) * w, rng.uniform(0.05, 0.25) * h
        colour = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            mask = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 <= 1
        else:
            mask = (abs(x - cx) <= rx) & (abs(y - cy) <= ry)
        img[mask] = colour
    img += rng.normal(0, 0.7, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main() -> None:
    rng = np.random.default_rng(2024)
    for name, w, h, mode, fmt in FIXTURES:
        rgb = picture(rng, w, h)
        im = Image.fromarray(rgb).convert(mode)
        im.save(os.path.join(HERE, f"{name}.JPEG"), format=fmt)
        if mode == "RGB" and fmt == "JPEG":
            Image.fromarray(rgb).save(os.path.join(HERE, f"{name}.png"))


if __name__ == "__main__":
    main()
