"""The port's transforms against the JAX package's, same inputs, same seeds.

The JAX transforms run on PIL images and the port's on uint8 arrays; both
draw from ``np.random.Generator`` with the same calls in the same order, so
one seed gives the same crop and flip.  uint8 results must be equal; f32
results are the same numpy arithmetic on equal uint8 inputs, held to 1e-6
(they come out equal).  Cases: downscaling and upscaling crops, the
10-try fallback branch (a 10x200 image, whose every draw fails), a
CenterCrop larger than the image (zero borders, as PIL pads), and gray
input.
"""

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_tpu.data import transforms as jt
from pytorch_distributed_tpu_torch.data import transforms as tt

SHAPES = [(60, 80), (80, 60), (10, 200), (200, 10), (12, 15), (33, 33)]


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


def _same(got, want, f32):
    want = np.asarray(want)
    assert got.shape == want.shape
    if f32:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want.astype(np.uint8))


def _run(port_tf, jax_tf, img, seed, f32=False):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    _same(np.asarray(port_tf(r1, img)), jax_tf(r2, Image.fromarray(img)), f32)
    assert r1.random() == r2.random()  # the same number of draws


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_single_transforms_match_jax(shape):
    img = _image(shape, sum(shape))
    for seed in range(6):
        for size in (16, 48):  # down- and up-scaling crops
            _run(tt.RandomResizedCrop(size), jt.RandomResizedCrop(size), img, seed)
        _run(tt.RandomHorizontalFlip(), jt.RandomHorizontalFlip(), img, seed)
    for size in (8, 36, 250):  # 250: upscaling
        _run(tt.Resize(size), jt.Resize(size), img, 0)
    for size in (7, 32, 240):  # 240: larger than the image, zero borders
        _run(tt.CenterCrop(size), jt.CenterCrop(size), img, 0)
    _run(tt.ToU8(), jt.ToU8(), img, 0)
    _run(tt.ToArray(), jt.ToArray(), img, 0, f32=True)
    f = img.astype(np.float32) / 255
    np.testing.assert_array_equal(tt.Normalize()(None, f), jt.Normalize()(None, f))


def test_fallback_branch_is_taken_and_matches():
    """A 10x200 strip: no draw fits in 10 tries, so both take the center
    crop of the constrained aspect."""
    img = _image((10, 200), 1)
    rng = np.random.default_rng(0)
    out = tt.RandomResizedCrop(24)(rng, img)
    assert out.shape == (24, 24, 3)
    np.testing.assert_array_equal(
        out, tt.resize_bilinear(tt.crop(img, (93, 0, 106, 10)), (24, 24)))
    _run(tt.RandomResizedCrop(24), jt.RandomResizedCrop(24), img, 0)


def test_center_crop_of_a_smaller_image_has_black_borders():
    img = _image((10, 12), 2) | 1  # no zero pixel inside
    out = tt.CenterCrop(16)(None, img)
    assert out.shape == (16, 16, 3)
    assert (out[:, 12:] == 0).all() and (out[10:] == 0).all()
    np.testing.assert_array_equal(out[:10, :12], img)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=lambda s: f"{s[0]}x{s[1]}")
def test_stacks_match_jax(shape):
    img = _image(shape, 7)
    for seed in range(4):
        _run(tt.train_transform(16), jt.train_transform(16), img, seed, f32=True)
        _run(tt.train_transform_u8(16), jt.train_transform_u8(16), img, seed)
    _run(tt.eval_transform(16, resize=20), jt.eval_transform(16, resize=20), img, 0, f32=True)
    _run(tt.eval_transform_u8(16, resize=20), jt.eval_transform_u8(16, resize=20), img, 0)
    _run(tt.eval_transform(32), jt.eval_transform(32), img, 0, f32=True)  # default 256


def test_gray_input_is_replicated():
    gray = _image((20, 30), 4)[..., 0]
    rgb = np.repeat(gray[..., None], 3, axis=2)
    for seed in range(3):
        a = tt.train_transform_u8(12)(np.random.default_rng(seed), gray)
        b = tt.train_transform_u8(12)(np.random.default_rng(seed), rgb)
        np.testing.assert_array_equal(a, b)
