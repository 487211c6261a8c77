"""The image formats the port decodes beside JPEG and 8-bit PNG, each held
bit for bit against PIL's ``Image.open(...).convert("RGB")``: BMP, GIF,
WebP, 16-bit and Adam7-interlaced PNG, PPM/PGM at any maxval; and the C++
plane built against the libjpeg that the Pillow wheel bundles, against the
system build and PIL.

Fixtures are made in ``tmp_path`` or in memory at test time: by PIL where
PIL writes the variant, otherwise by the short encoders below (BMP headers
and bitfields, PNG at 16 bits and interlaced, PNM at other maxvals, GIF
re-wrapped with a local palette and a frame offset).
"""

import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_tpu_torch.data import imageio
from pytorch_distributed_tpu_torch.data.native import binding

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "images")
RNG = np.random.default_rng(11)
RGB = RNG.integers(0, 256, (23, 37, 3), dtype=np.uint8)
RGBA = RNG.integers(0, 256, (23, 37, 4), dtype=np.uint8)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_like_pil(data: bytes, name: str) -> None:
    got = imageio.decode_image(data, name)
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _saved(im: Image.Image, fmt: str, **kw) -> bytes:
    f = io.BytesIO()
    im.save(f, fmt, **kw)
    return f.getvalue()


# ---------------------------------------------------------------- BMP
def _bmp(pixels: np.ndarray, bits: int, palette=None, top_down=False, masks=None,
         hsize=40) -> bytes:
    """A BMP of ``pixels`` ([h, w] indices for bits <= 8, else [h, w, k]
    bytes already in file order), rows padded to 4 bytes."""
    h, w = pixels.shape[:2]
    if bits < 8:
        packed = np.packbits(np.unpackbits(pixels[..., None].astype(np.uint8), axis=2)
                             [:, :, 8 - bits:].reshape(h, -1), axis=1)
    else:
        packed = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    if not top_down:
        rows = rows[::-1]
    pal = b""
    if palette is not None:
        pad = 3 if hsize == 12 else 4
        entries = np.zeros((len(palette), pad), np.uint8)
        entries[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal = entries.tobytes()
    extra = struct.pack("<III", *masks[:3]) if masks is not None and hsize == 40 else b""
    if hsize == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits,
                          0 if masks is None else 3, rows.size, 2835, 2835,
                          0 if palette is None else len(palette), 0)
        if hsize > 40:
            m = tuple(masks or (0, 0, 0, 0)) + (0,) * 4
            dib += struct.pack("<IIII", *m[:4]) + bytes(hsize - 56)
    offset = 14 + len(dib) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset) + dib + extra
            + pal + rows.tobytes())


def _bmp_cases():
    idx8 = RNG.integers(0, 200, (23, 37), dtype=np.uint8)
    pal = RNG.integers(0, 256, (200, 3), dtype=np.uint8)
    bgr = RGB[..., ::-1]
    bgrx = np.concatenate([bgr, RNG.integers(0, 256, (23, 37, 1), dtype=np.uint8)], axis=2)
    v555 = RNG.integers(0, 1 << 15, (23, 37), dtype=np.uint16)
    v565 = RNG.integers(0, 1 << 16, (23, 37), dtype=np.uint16)
    b16 = lambda v: v.astype("<u2").view(np.uint8).reshape(23, 37, 2)  # noqa: E731
    return {
        "pil_1": _saved(Image.fromarray(RGB).convert("1"), "BMP"),
        "pil_L": _saved(Image.fromarray(RGB).convert("L"), "BMP"),
        "pil_P": _saved(Image.fromarray(RGB).convert("P"), "BMP"),
        "pil_rgb": _saved(Image.fromarray(RGB), "BMP"),
        "pil_rgba_bitfields": _saved(Image.fromarray(RGBA), "BMP"),
        "1bit_palette": _bmp(idx8 % 2, 1, palette=[(10, 200, 30), (250, 5, 99)]),
        "4bit": _bmp(idx8 % 16, 4, palette=pal[:16]),
        "4bit_top_down": _bmp(idx8 % 16, 4, palette=pal[:16], top_down=True),
        "8bit_short_palette": _bmp(idx8, 8, palette=pal[:150]),
        "8bit_core_header": _bmp(idx8, 8, palette=pal, hsize=12),
        "16bit_555": _bmp(b16(v555), 16),
        "16bit_565_bitfields": _bmp(b16(v565), 16, masks=(0xF800, 0x7E0, 0x1F)),
        "24bit_top_down": _bmp(bgr, 24, top_down=True),
        "32bit_rgb": _bmp(bgrx, 32),
        "32bit_bitfields_xbgr": _bmp(bgrx, 32, masks=(0xFF000000, 0xFF0000, 0xFF00, 0),
                                     hsize=108),
        "32bit_bitfields_rgba": _bmp(bgrx, 32, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                     hsize=124),
    }


@pytest.mark.parametrize("case", sorted(_bmp_cases()))
def test_bmp_matches_pil(case):
    _assert_like_pil(_bmp_cases()[case], f"{case}.bmp")


# ---------------------------------------------------------------- PNG
def _png(samples: np.ndarray, ctype: int, depth: int, interlace: bool = False,
         palette=None) -> bytes:
    """A PNG of ``samples`` [h, w, channels] (uint16 at 16 bits), rows
    filtered None, Sub and Up in turn; Adam7 when ``interlace``."""
    h, w, c = samples.shape

    def rows_of(px):
        ph, pw = px.shape[:2]
        if depth < 8:
            bits = np.unpackbits(px.astype(np.uint8), axis=2)[:, :, 8 - depth:]
            raw = np.packbits(bits.reshape(ph, -1), axis=1)
        elif depth == 16:
            raw = px.astype(">u2").view(np.uint8).reshape(ph, -1)
        else:
            raw = px.astype(np.uint8).reshape(ph, -1)
        bpp = max(1, c * depth // 8)
        out = []
        for y in range(ph):
            ft = y % 3
            r = raw[y].astype(np.int32)
            if ft == 1:
                r = r - np.concatenate([np.zeros(bpp, np.int32), raw[y, :-bpp]])
            elif ft == 2:
                r = r - (raw[y - 1] if y else np.zeros_like(raw[y]))
            out.append(bytes([ft]) + (r % 256).astype(np.uint8).tobytes())
        return b"".join(out)

    if interlace:
        data = b"".join(rows_of(samples[y0::dy, x0::dx])
                        for x0, y0, dx, dy in imageio._ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = rows_of(samples)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    plte = chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if palette is not None \
        else b""
    return (imageio.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + plte
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _png_cases():
    def s16(c):
        return RNG.integers(0, 1 << 16, (23, 37, c), dtype=np.uint16)

    def s8(c, depth=8):
        return RNG.integers(0, 1 << depth, (23, 37, c), dtype=np.uint8)

    small = RNG.integers(0, 300, (23, 37, 1)).astype(np.uint16)  # straddles 255
    pal = RNG.integers(0, 256, (16, 3), dtype=np.uint8)
    cases = {
        "gray16": _png(s16(1), 0, 16),
        "gray16_low_values": _png(small, 0, 16),
        "rgb16": _png(s16(3), 2, 16),
        "gray_alpha16": _png(s16(2), 4, 16),
        "rgba16": _png(s16(4), 6, 16),
    }
    for name, (px, ctype, depth, p) in {
            "rgb8": (s8(3), 2, 8, None), "rgba8": (s8(4), 6, 8, None),
            "gray1": (s8(1, 1), 0, 1, None), "gray4": (s8(1, 4), 0, 4, None),
            "palette4": (s8(1, 4), 3, 4, pal), "gray_alpha8": (s8(2), 4, 8, None),
            "rgb16": (s16(3), 2, 16, None), "gray16": (small, 0, 16, None)}.items():
        cases[f"adam7_{name}"] = _png(px, ctype, depth, interlace=True, palette=p)
    cases["adam7_tiny_3x2"] = _png(RNG.integers(0, 256, (2, 3, 3), dtype=np.uint8), 2, 8,
                                   interlace=True)
    return cases


@pytest.mark.parametrize("case", sorted(_png_cases()))
def test_png_16bit_and_interlaced_match_pil(case):
    _assert_like_pil(_png_cases()[case], f"{case}.png")


# ---------------------------------------------------------------- PNM
def _pnm(magic: bytes, px: np.ndarray, maxval: int) -> bytes:
    h, w = px.shape[:2]
    body = px.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + b"\n# made by the test\n%d %d\n%d\n" % (w, h, maxval) + body


@pytest.mark.parametrize("magic,channels", [(b"P6", 3), (b"P5", 1)])
@pytest.mark.parametrize("maxval", [1000, 15, 65535, 255])
def test_pnm_any_maxval_matches_pil(magic, channels, maxval):
    px = RNG.integers(0, maxval + 1, (23, 37, channels))
    if maxval == 1000:
        px[0, :5] = maxval + 7  # samples above maxval, which PIL clips
    _assert_like_pil(_pnm(magic, px.squeeze(-1) if channels == 1 else px, maxval),
                     f"maxval{maxval}.pnm")


# ---------------------------------------------------------------- GIF
def _gif_parts(data: bytes):
    """PIL's single-frame GIF split into (global palette, extension bytes,
    the image's LZW bytes from the min-code-size byte on, interlace flag)."""
    flags = data[10]
    n = 3 << ((flags & 7) + 1)
    pal, pos = data[13:13 + n], 13 + n
    ext = b""
    while data[pos:pos + 1] == b"!":
        end = pos + 2
        while data[end]:
            end += data[end] + 1
        ext += data[pos:end + 1]
        pos = end + 1
    assert data[pos:pos + 1] == b","
    iflags = data[pos + 9]
    return pal, flags, ext, data[pos + 10:].rstrip(b";"), iflags


def _gif_local(data: bytes, screen=(50, 40), offset=(7, 5)) -> bytes:
    """PIL's GIF re-wrapped: no global palette, the palette local to the
    image, the image at ``offset`` on a larger logical screen."""
    pal, flags, ext, lzw, iflags = _gif_parts(data)
    w, h = struct.unpack_from("<HH", data, 6)
    head = b"GIF89a" + struct.pack("<HHBBB", screen[0], screen[1], flags & 0x70, 0, 0)
    desc = b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h,
                              0x80 | (iflags & 0x40) | (flags & 7))
    return head + ext + desc + pal + lzw + b";"


def _gif_cases():
    im = Image.fromarray(RGB).convert("P")
    big = Image.fromarray(np.repeat(np.repeat(RGB, 2, 0), 2, 1)).convert("P")
    cases = {
        "global_palette": _saved(im, "GIF"),
        "interlaced": _saved(big, "GIF", interlace=True),
        "not_interlaced": _saved(big, "GIF", interlace=False),
        "transparency": _saved(im, "GIF", transparency=3),
        "gray": _saved(Image.fromarray(RGB).convert("L"), "GIF"),
        "two_colours": _saved(Image.fromarray(RGB).convert("1"), "GIF"),
        "animated_first_frame": _saved(im, "GIF", save_all=True,
                                       append_images=[im.transpose(0)]),
        "local_palette_offset": _gif_local(_saved(im, "GIF")),
        "local_palette_offset_transparency": _gif_local(_saved(im, "GIF", transparency=5)),
        "local_palette_interlaced": _gif_local(_saved(big, "GIF", interlace=True),
                                               screen=(90, 60), offset=(3, 9)),
    }
    return cases


@pytest.mark.parametrize("case", sorted(_gif_cases()))
def test_gif_first_frame_matches_pil(case):
    _assert_like_pil(_gif_cases()[case], f"{case}.gif")


# ---------------------------------------------------------------- WebP
def _webp_cases():
    rgb, rgba = Image.fromarray(RGB), Image.fromarray(RGBA)
    return {
        "lossy": _saved(rgb, "WEBP", quality=80),
        "lossless": _saved(rgb, "WEBP", lossless=True),
        "lossy_alpha": _saved(rgba, "WEBP", quality=70),
        "lossless_alpha": _saved(rgba, "WEBP", lossless=True),
        "animated": _saved(rgb, "WEBP", save_all=True, append_images=[rgb.transpose(0)]),
        "animated_alpha": _saved(rgba, "WEBP", save_all=True, lossless=True,
                                 append_images=[rgba.transpose(0)]),
    }


@pytest.mark.parametrize("case", sorted(_webp_cases()))
def test_webp_matches_pil(case):
    _assert_like_pil(_webp_cases()[case], f"{case}.webp")


def test_files_decode_through_read_image(tmp_path):
    """One file of each new format, read from disk by ``read_image``."""
    files = {"a.bmp": _bmp_cases()["4bit"], "b.gif": _gif_cases()["interlaced"],
             "c.webp": _webp_cases()["lossy"], "d.png": _png_cases()["adam7_rgb16"],
             "e.ppm": _pnm(b"P6", RNG.integers(0, 1001, (5, 4, 3)), 1000)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(imageio.read_image(str(tmp_path / name)),
                                      _pil(data))


def test_tiff_still_raises_naming_the_file(tmp_path):
    path = tmp_path / "misnamed.JPEG"
    Image.fromarray(RGB).save(path, "TIFF")
    with pytest.raises(imageio.UnsupportedImageError, match="misnamed.JPEG: TIFF"):
        imageio.read_image(str(path))


# ---------------------------------------------------------------- libjpeg
def test_plane_against_pillow_bundled_libjpeg_decodes_fixtures_like_system_and_pil():
    """The plane built against the vendored jpeg62 headers and the libjpeg
    that the Pillow wheel carries (found by path, PIL not imported by the
    port) decodes the committed JPEG fixtures to the bits of the system
    libjpeg's build and of PIL."""
    libs = binding.pillow_libs_dir()
    wheel = sorted(glob.glob(str(libs / "libjpeg-*.so.62*"))) if libs else []
    assert wheel, "the Pillow wheel carries no libjpeg.so.62"
    wheel_so = binding.build(jpeg=wheel[0], webp=None)
    default_so = binding.build()
    assert wheel_so != default_so and wheel_so.name.endswith("-nowebp.so")
    wheel_lib = binding.open_library(wheel_so)
    default_lib = binding.open_library(default_so)
    files = sorted(p for p in glob.glob(os.path.join(FIXTURES, "*.JPEG"))
                   if open(p, "rb").read(3) == b"\xff\xd8\xff")
    assert len(files) >= 7
    for path in files:
        blob = open(path, "rb").read()
        got = binding.decode_jpeg(blob, path, lib=wheel_lib)
        np.testing.assert_array_equal(got, binding.decode_jpeg(blob, path, lib=default_lib))
        np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_digest_names_the_linked_libraries(tmp_path):
    """A plane linked to another library (another host's path) is another
    file; one built without a library says so in its name and its decode
    raises naming what was searched."""
    fake = tmp_path / "libjpeg.so.62"
    fake.write_bytes(b"\0" * 16)
    a = binding._target({"jpeg": str(fake), "webp": None})
    fake.write_bytes(b"\0" * 17)
    assert binding._target({"jpeg": str(fake), "webp": None}) != a
    none = binding.open_library(binding.build(jpeg=None, webp=None))
    assert binding._target({"jpeg": None, "webp": None}).name.endswith("-nojpeg-nowebp.so")
    with pytest.raises(RuntimeError, match=r"x\.JPEG: .*without libjpeg \(searched: "):
        binding.decode_jpeg(open(os.path.join(FIXTURES, "rgb0.JPEG"), "rb").read(),
                            "x.JPEG", lib=none)
    with pytest.raises(FileNotFoundError, match="no jpeg library"):
        binding.build(jpeg=str(tmp_path / "missing.so"))
