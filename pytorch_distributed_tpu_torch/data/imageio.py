"""Image files to uint8 RGB arrays without PIL: the port's
``Image.open(path).convert("RGB")``.

The port does not depend on PIL, so it decodes on its own, choosing the
decoder by the file's magic bytes (as PIL does), never by its extension:

- JPEG through the C++ data plane (``data/native``), decoded as PIL decodes
  (ISLOW, fancy upsampling; gray replicated; 4-component files as inverted
  CMYK converted by PIL's formula);
- PNG, non-interlaced: gray at 1, 2, 4 or 8 bits, palette at 1, 2, 4 or 8
  bits, gray + alpha, RGB and RGBA at 8 bits; stdlib ``zlib`` inflates, the
  C++ plane undoes the row filters; alpha is dropped and palettes expanded,
  as ``convert("RGB")`` does;
- binary PPM and PGM (``P6``, ``P5``) with maxval 255, in numpy.

Anything else (WebP, BMP, GIF, TIFF, interlaced or 16-bit PNG) raises
``UnsupportedImageError`` naming the file and its format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from pytorch_distributed_tpu_torch.data.native import decode_jpeg, png_unfilter

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


class UnsupportedImageError(ValueError):
    """A file whose format the port does not decode."""


def sniff(data: bytes) -> str:
    """The format named by the first bytes: ``JPEG``, ``PNG``, ``PPM``,
    ``PGM``, another format's name, or ``unknown``."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:8] == PNG_SIGNATURE:
        return "PNG"
    if data[:2] == b"P6":
        return "PPM"
    if data[:2] == b"P5":
        return "PGM"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"7"):
        return f"PNM P{data[1:2].decode()}"
    return "unknown"


def read_image(path: str) -> np.ndarray:
    """The file at ``path`` as uint8 [h, w, 3] RGB."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, str(path))


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Encoded image bytes as uint8 [h, w, 3] RGB; ``name`` labels errors."""
    fmt = sniff(data)
    if fmt == "JPEG":
        return decode_jpeg(data, name)
    if fmt == "PNG":
        return _decode_png(data, name)
    if fmt in ("PPM", "PGM"):
        return _decode_pnm(data, name)
    raise UnsupportedImageError(
        f"{name}: {fmt} images are not decoded by the port (JPEG, non-interlaced 8-bit "
        "PNG and binary PPM/PGM are)")


def _unsupported(name: str, what: str) -> UnsupportedImageError:
    return UnsupportedImageError(f"{name}: {what} PNG images are not decoded by the port")


def _decode_png(data: bytes, name: str) -> np.ndarray:
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        pos += 12 + length  # length, type, body, CRC
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or image data")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not defined")
    if interlace:
        raise _unsupported(name, "interlaced (Adam7)")
    if depth not in _PNG_DEPTHS[ctype]:
        raise _unsupported(name, f"{depth}-bit colour type {ctype}")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = -(-width * channels * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    rows = png_unfilter(raw, height, rowbytes, max(1, channels * depth // 8))
    if depth < 8:  # gray or palette indices packed 8 // depth to a byte
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        rows = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)[:, :width]
    px = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype == 0:  # gray: PIL scales 1-, 2- and 4-bit samples to 0..255
        return np.repeat(px * np.uint8(255 // (2 ** depth - 1)), 3, axis=2)
    if ctype == 4:  # gray + alpha: alpha dropped
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])  # RGB, or RGBA with alpha dropped


def _pnm_header(data: bytes, name: str):
    """``(width, height, maxval, offset of the pixel data)``."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError(f"{name}: malformed PNM header")
        fields.append(int(data[start:pos]))
    return fields[0], fields[1], fields[2], pos + 1  # one whitespace byte ends it


def _decode_pnm(data: bytes, name: str) -> np.ndarray:
    width, height, maxval, off = _pnm_header(data, name)
    if maxval != 255:
        raise UnsupportedImageError(f"{name}: PNM with maxval {maxval} is not decoded by "
                                    "the port (maxval 255 is)")
    channels = 3 if data[:2] == b"P6" else 1
    n = width * height * channels
    if len(data) - off < n:
        raise ValueError(f"{name}: truncated PNM pixel data")
    px = np.frombuffer(data, np.uint8, count=n, offset=off).reshape(height, width, channels)
    return np.repeat(px, 3, axis=2) if channels == 1 else px.copy()
