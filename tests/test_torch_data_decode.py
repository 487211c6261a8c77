"""The port's image decoding and PIL's resample, against PIL itself.

The port does not depend on PIL and decodes with its own code
(``data/imageio.py`` over the C++ data plane); here PIL is the oracle.
Every comparison is bit-exact:

- JPEG: the port's libjpeg decode (ISLOW, fancy upsampling) against
  ``Image.open(p).convert("RGB")`` for RGB at three chroma subsamplings,
  progressive, grayscale and CMYK files, and the committed fixtures
  (``tests/data/images``, one of them a PNG under a ``.JPEG`` name).  Both
  sides run libjpeg-turbo's integer IDCT and upsampling, which give the
  same bits across its versions.
- PNG: every colour type and bit depth PIL writes (RGB, RGBA, L, LA, 1-bit,
  and palettes of 1, 2, 4 and 8 bits), plus files written here with each of
  the five row filters and with 2- and 4-bit gray; PPM and PGM with a
  header comment.
- ``resize_bilinear`` against ``Image.resize(..., BILINEAR)`` on random
  sizes, up and down.
- Formats the port does not decode raise naming the file and the format;
  a plane built without libjpeg (as on the card's host) says so, and its
  JPEG decode raises; a failed build raises; a library built elsewhere is
  rebuilt.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_tpu_torch.data import imageio
from pytorch_distributed_tpu_torch.data.native import binding

FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _photo(rng, h, w, channels=3):
    """Smooth content plus noise, so JPEG's upsampling and IDCT matter."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / (5 + c) + y / (7 + 2 * c)) for c in range(channels)],
                    axis=-1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_rgb_jpeg_matches_pil(subsampling, progressive):
    rng = np.random.default_rng(subsampling + 3 * progressive)
    data = _saved(Image.fromarray(_photo(rng, 37, 61)), "JPEG", subsampling=subsampling,
                  progressive=progressive)
    np.testing.assert_array_equal(imageio.decode_image(data), _pil(data))


@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_gray_and_cmyk_jpeg_match_pil(mode):
    rng = np.random.default_rng(5)
    arr = _photo(rng, 45, 29, channels=4)
    im = Image.fromarray(arr[..., 0]) if mode == "L" else Image.fromarray(arr, "CMYK")
    data = _saved(im, "JPEG", quality=90)
    np.testing.assert_array_equal(imageio.decode_image(data), _pil(data))


def test_committed_fixtures_decode_as_pil_does():
    files = sorted(p for p in FIXTURES.iterdir() if p.suffix in (".JPEG", ".png"))
    assert len(files) == 13
    kinds = {imageio.sniff(p.read_bytes()) for p in files}
    assert kinds == {"JPEG", "PNG"}
    for p in files:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(imageio.read_image(str(p)), want, err_msg=p.name)


def _p_mode(arr, colours):
    return Image.fromarray(arr).quantize(colours)


@pytest.mark.parametrize("make", [
    lambda a: Image.fromarray(a),
    lambda a: Image.fromarray(np.dstack([a, a[..., :1]]), "RGBA"),
    lambda a: Image.fromarray(a[..., 1]),
    lambda a: Image.fromarray(np.dstack([a[..., 0], a[..., 2]]), "LA"),
    lambda a: Image.fromarray(a[..., 0] > 127),
    lambda a: _p_mode(a, 2), lambda a: _p_mode(a, 4), lambda a: _p_mode(a, 16),
    lambda a: _p_mode(a, 256)],
    ids=["RGB", "RGBA", "L", "LA", "1", "P1", "P2", "P4", "P8"])
def test_png_modes_match_pil(make):
    rng = np.random.default_rng(7)
    data = _saved(make(rng.integers(0, 256, (23, 41, 3), dtype=np.uint8)), "PNG")
    np.testing.assert_array_equal(imageio.decode_image(data), _pil(data))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_row(ft, row, prev, bpp):
    """PNG filter ``ft`` of one row (ints), from the specification."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return bytes([ft] + out)


def _png(rows: np.ndarray, width: int, depth: int, ctype: int, filters, interlace=0):
    """A PNG of the packed ``rows`` [h, rowbytes], row y filtered by
    ``filters[y % len(filters)]``."""
    bpp = max(1, {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8)
    prev = [0] * rows.shape[1]
    raw = b""
    for y, row in enumerate(rows.tolist()):
        raw += _filter_row(filters[y % len(filters)], row, prev, bpp)
        prev = row
    ihdr = struct.pack(">IIBBBBB", width, rows.shape[0], depth, ctype, 0, 0, interlace)
    return (imageio.PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_each_png_filter_matches_pil(ft):
    rng = np.random.default_rng(ft)
    px = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    data = _png(px.reshape(9, -1), 11, 8, 6, [ft])
    got = imageio.decode_image(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, px[..., :3])


@pytest.mark.parametrize("depth", [2, 4])
def test_packed_gray_png_matches_pil(depth):
    rng = np.random.default_rng(depth)
    width = 13
    vals = rng.integers(0, 2 ** depth, (6, width), dtype=np.uint8)
    per = 8 // depth
    padded = np.zeros((6, -(-width // per) * per), np.uint8)
    padded[:, :width] = vals
    shifts = np.arange(per - 1, -1, -1) * depth
    packed = (padded.reshape(6, -1, per) << shifts).sum(axis=2).astype(np.uint8)
    data = _png(packed, width, depth, 0, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(imageio.decode_image(data), _pil(data))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_ppm_pgm_match_pil(mode):
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 256, (17, 21, 3), dtype=np.uint8)
    im = Image.fromarray(arr) if mode == "RGB" else Image.fromarray(arr[..., 0])
    data = _saved(im, "PPM")
    magic, rest = data[:2], data[2:]
    commented = magic + b"\n# a comment\n" + rest.lstrip()
    for d in (data, commented):
        np.testing.assert_array_equal(imageio.decode_image(d), _pil(data))


def test_resize_matches_pil_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(60):
        ih, iw, oh, ow = (int(v) for v in rng.integers(1, 90, 4))
        arr = rng.integers(0, 256, (ih, iw, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(arr).resize((ow, oh), resample=Image.BILINEAR))
        np.testing.assert_array_equal(binding.resize_bilinear(arr, (ow, oh)), want,
                                      err_msg=f"{iw}x{ih} -> {ow}x{oh}")


def test_unsupported_formats_raise_naming_the_file(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    bmp = bytearray(_saved(Image.fromarray(arr[..., 0]).convert("P"), "BMP"))
    bmp[30:34] = (1).to_bytes(4, "little")  # BI_RLE8
    cases = {
        "a.tif": (_saved(Image.fromarray(arr), "TIFF"), "TIFF"),
        "rle.bmp": (bytes(bmp), "BMP compression 1"),
        "ascii.ppm": (b"P3\n2 1\n255\n1 2 3 4 5 6\n", "PNM P3"),
        "text.jpg": (b"not an image at all", "unknown"),
    }
    for name, (data, what) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(imageio.UnsupportedImageError, match=what) as exc:
            imageio.read_image(str(path))
        assert str(path) in str(exc.value)


def test_corrupt_jpeg_raises_naming_the_file(tmp_path):
    data = _saved(Image.fromarray(np.zeros((16, 16, 3), np.uint8)), "JPEG")
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:40])
    with pytest.raises(ValueError, match="cut.jpg"):
        imageio.read_image(str(path))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a library that does not build raises with g++'s
    output."""
    bad = tmp_path / "ptd_data.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(binding, "_SRC", bad)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_lib", None)
    with pytest.raises(RuntimeError, match="could not build the C\\+\\+ data plane"):
        binding.native_available()


def test_library_from_another_host_is_rebuilt(monkeypatch, tmp_path):
    """A copied build directory can hold a library that links a libjpeg
    this host lacks: it is built again instead of failing to load."""
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(binding, "_lib", None)
    binding._target(binding.resolve_libraries()).write_bytes(b"built on another host")
    assert binding.native_available()
    assert binding.resize_bilinear(np.zeros((2, 2, 3), np.uint8), (3, 3)).shape == (3, 3, 3)


def test_a_plane_without_libjpeg_says_so(monkeypatch, tmp_path):
    """A host with no libjpeg at all: the plane built with -DPTD_NO_JPEG
    reports it, JPEG files raise naming the file, the rest still decodes."""
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path)
    so = binding.build(jpeg=None)
    monkeypatch.setattr(binding, "build", lambda: so)
    monkeypatch.setattr(binding, "_lib", None)
    assert not binding.jpeg_native_available()
    jpeg = _saved(Image.fromarray(np.zeros((8, 8, 3), np.uint8)), "JPEG")
    with pytest.raises(RuntimeError, match="a.jpg: the C\\+\\+ data plane was built without"):
        imageio.decode_image(jpeg, "a.jpg")
    png = _saved(Image.fromarray(np.full((8, 8, 3), 7, np.uint8)), "PNG")
    np.testing.assert_array_equal(imageio.decode_image(png), _pil(png))
