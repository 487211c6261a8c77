"""Image files to uint8 RGB arrays without PIL: the port's
``Image.open(path).convert("RGB")``, bit for bit.

The port does not depend on PIL, so it decodes on its own, choosing the
decoder by the file's magic bytes (as PIL does), never by its extension:

- JPEG through the C++ data plane (``data/native``, libjpeg), decoded as
  PIL decodes (ISLOW, fancy upsampling; gray replicated; 4-component files
  as inverted CMYK converted by PIL's formula);
- WebP through the plane's libwebp: the first frame, its alpha dropped;
- PNG, every colour type and bit depth, interlaced (Adam7) or not: stdlib
  ``zlib`` inflates, the C++ plane undoes the row filters; alpha is dropped
  and palettes expanded, 16-bit samples reduced as PIL reduces them (the
  high byte; 16-bit gray, which PIL opens as ``I;16``, clipped at 255);
- BMP: 1-, 4- and 8-bit palettes, 16-bit 5-5-5 and 5-6-5, 24- and 32-bit,
  bottom-up or top-down, ``BI_RGB`` or ``BI_BITFIELDS`` with the masks PIL
  reads;
- GIF: the first frame on its logical screen, LZW in the C++ plane, the
  local or global palette, interlaced rows;
- binary PPM and PGM (``P6``, ``P5``) at any maxval, scaled as PIL scales.

Anything else (TIFF, RLE-compressed BMP, ASCII PNM, ...) raises
``UnsupportedImageError`` naming the file and its format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from pytorch_distributed_tpu_torch.data.native import (
    decode_jpeg,
    decode_webp_rgba,
    gif_lzw,
    png_unfilter,
    webp_info,
)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x start, y start, x step, y step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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
    decoder = _DECODERS.get(fmt)
    if decoder is None:
        raise UnsupportedImageError(
            f"{name}: {fmt} images are not decoded by the port (JPEG, WebP, PNG, BMP, GIF "
            "and binary PPM/PGM are)")
    return decoder(data, name)


def _lut(palette=None) -> np.ndarray:
    """Index -> RGB as PIL converts: through the palette, black past its
    end; without a palette (PIL's ``L``), gray."""
    if palette is None:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(palette), 256)] = palette[:256]
    return lut


def _png_samples(rows: np.ndarray, height: int, width: int, channels: int,
                 depth: int) -> np.ndarray:
    """Unfiltered PNG rows -> samples [h, w, channels] (uint16 at 16 bits)."""
    if depth < 8:  # gray or palette indices packed 8 // depth to a byte
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)[:, :width]
        return px.reshape(height, width, 1)
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(np.uint16)
    return rows.reshape(height, width, channels)


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
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or image data")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not defined")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG bit depth {depth} is not defined for colour type "
                         f"{ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace} is not defined")
    channels = _PNG_CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None

    def rowbytes(w: int) -> int:
        return -(-w * channels * depth // 8)

    if not interlace:
        px = _png_samples(png_unfilter(raw, height, rowbytes(width), bpp), height, width,
                          channels, depth)
    else:
        px = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes at all
            n = ph * (rowbytes(pw) + 1)
            rows = png_unfilter(raw[off:off + n], ph, rowbytes(pw), bpp)
            px[y0::dy, x0::dx] = _png_samples(rows, ph, pw, channels, depth)
            off += n
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        return _lut(palette)[px[..., 0]]
    if depth == 16:
        # PIL opens 16-bit gray as I;16, whose RGB conversion clips at 255;
        # the other 16-bit types unpack their samples' high bytes.
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    if ctype == 0:  # gray: PIL scales 1-, 2- and 4-bit samples to 0..255
        scale = 255 // (2 ** depth - 1) if depth < 8 else 1
        return np.repeat(px * np.uint8(scale), 3, axis=2)
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
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM maxval {maxval} is outside 1..65535")
    channels = 3 if data[:2] == b"P6" else 1
    n = width * height * channels
    wide = maxval > 255
    if len(data) - off < n * (2 if wide else 1):
        raise ValueError(f"{name}: truncated PNM pixel data")
    v = np.frombuffer(data, ">u2" if wide else np.uint8, count=n, offset=off)
    if maxval != 255:
        if wide and channels == 1:
            # PIL opens such a PGM as 32-bit "I" scaled to 0..65535 (65535
            # as it is), whose RGB conversion clips at 255.
            if maxval != 65535:
                v = np.minimum(65535, np.round(v / maxval * 65535))
            v = np.minimum(v, 255)
        else:  # PIL's PpmDecoder: min(255, round(value / maxval * 255))
            v = np.minimum(255, np.round(v / maxval * 255))
    px = v.astype(np.uint8).reshape(height, width, channels)
    return np.repeat(px, 3, axis=2) if channels == 1 else px.copy()


# 32-bit BI_BITFIELDS masks PIL reads (BmpImagePlugin's SUPPORTED), as byte
# offsets of R, G and B in each little-endian pixel.
_BMP32_MASKS = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}
_BMP16_MASKS = {(0xF800, 0x7E0, 0x1F): 6, (0x7C00, 0x3E0, 0x1F): 5}  # green bits


def _decode_bmp(data: bytes, name: str) -> np.ndarray:
    if len(data) < 26:
        raise ValueError(f"{name}: truncated BMP header")
    offset, hsize = struct.unpack_from("<II", data, 10)
    hdr = data[18:14 + hsize]
    pos = 14 + hsize
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", hdr)
        compression, colors, top_down, pad = 0, 0, False, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        width, height, _, bits, compression = struct.unpack_from("<iiHHI", hdr)
        colors = struct.unpack_from("<I", hdr, 28)[0]
        top_down, pad = height < 0, 4
        height = abs(height)
    else:
        raise UnsupportedImageError(f"{name}: BMP header of {hsize} bytes")
    if compression not in (0, 3):
        raise UnsupportedImageError(f"{name}: BMP compression {compression} (RLE, JPEG or "
                                    "PNG) is not decoded by the port")
    masks = None
    if compression == 3:
        if len(hdr) >= 48:
            masks = struct.unpack_from("<IIII" if len(hdr) >= 52 else "<III", hdr, 36)
        else:
            masks = struct.unpack_from("<III", data, pos)
            pos += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    stride = ((width * bits + 31) >> 3) & ~3
    if len(data) < offset + stride * height:
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
    rows = rows.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits in (1, 4, 8):
        if compression:
            raise UnsupportedImageError(f"{name}: {bits}-bit BMP with bitfields")
        pal = np.frombuffer(data, np.uint8, count=pad * colors, offset=pos)
        pal = pal.reshape(colors, pad)[:, 2::-1]
        idx = _png_samples(np.ascontiguousarray(rows[:, :(width * bits + 7) // 8]), height,
                           width, 1, bits)[..., 0]
        return _lut(pal)[idx]
    if bits == 16:
        green = 5 if masks is None else _BMP16_MASKS.get(masks[:3])
        if green is None:
            raise UnsupportedImageError(f"{name}: BMP bitfields {masks[:3]} are not read by "
                                        "PIL or the port")
        v = rows[:, :2 * width].copy().view("<u2").astype(np.uint32)
        b = (v & 31) * 255 // 31
        g = ((v >> 5) & (2 ** green - 1)) * 255 // (2 ** green - 1)
        r = ((v >> (5 + green)) & 31) * 255 // 31
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    if bits == 24:
        if masks is not None and masks[:3] != (0xFF0000, 0xFF00, 0xFF):
            raise UnsupportedImageError(f"{name}: BMP bitfields {masks[:3]} are not read by "
                                        "PIL or the port")
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[..., ::-1])
    if bits == 32:
        order = (2, 1, 0) if masks is None else _BMP32_MASKS.get(masks)
        if order is None:
            raise UnsupportedImageError(f"{name}: BMP bitfields {masks} are not read by PIL "
                                        "or the port")
        return np.ascontiguousarray(rows[:, :4 * width].reshape(height, width, 4)[..., order])
    raise UnsupportedImageError(f"{name}: {bits}-bit BMP")


def _gif_blocks(data: bytes, pos: int, name: str):
    """``(payload of the sub-blocks at pos, position after them)``."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF data")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n


def _decode_gif(data: bytes, name: str) -> np.ndarray:
    """The first frame as PIL's GifImagePlugin loads it: the logical screen
    (grown to hold the frame), filled with the frame's transparent index, or
    index 0, then the frame's indices at its offset, through the local or
    global palette."""
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos, palette = 13, None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        palette = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos:pos + 1] == b";":
            raise ValueError(f"{name}: GIF without an image")
        tag = data[pos:pos + 1]
        pos += 1
        if tag == b"!":
            label = data[pos]
            block, pos = _gif_blocks(data, pos + 1, name)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
        elif tag == b",":
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if iflags & 128:
                n = 3 << ((iflags & 7) + 1)
                palette = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
                pos += n
            min_code = data[pos]
            lzw, pos = _gif_blocks(data, pos + 1, name)
            break
        else:
            raise ValueError(f"{name}: unknown GIF block {tag!r}")
    W, H = max(sw, x0 + w), max(sh, y0 + h)
    canvas = np.full((H, W), transparency or 0, np.uint8)
    idx = np.zeros(w * h, np.uint8)
    got = gif_lzw(lzw, min_code, w * h)
    idx[:len(got)] = got
    if len(got) < w * h:  # PIL leaves what a short stream does not reach
        rest = canvas[y0:y0 + h, x0:x0 + w].reshape(-1)
        idx[len(got):] = rest[len(got):]
    frame = idx.reshape(h, w)
    if iflags & 64:  # interlaced: rows 0::8, 4::8, 2::4, 1::2, in that order
        order = np.concatenate([np.arange(s, h, d) for s, d in ((0, 8), (4, 8), (2, 4),
                                                               (1, 2))])
        frame = np.empty_like(frame)
        frame[order] = idx.reshape(h, w)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    return _lut(palette)[canvas]


def _riff_chunks(data: bytes, pos: int, end: int):
    """``[(fourcc, offset of the chunk, its payload)]`` of a RIFF list."""
    out = []
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((fourcc, pos, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _decode_webp(data: bytes, name: str) -> np.ndarray:
    """The first frame's RGB as PIL's WebPAnimDecoder composes it: a still
    image decoded whole; an animation's first frame at its offset on a
    canvas of transparent black."""
    w, h, _, animated = webp_info(data, name)
    if not animated:
        return np.ascontiguousarray(decode_webp_rgba(data, name)[..., :3])
    chunks = _riff_chunks(data, 12, len(data))
    anmf = next((c for c in chunks if c[0] == b"ANMF"), None)
    if anmf is None:
        raise ValueError(f"{name}: animated WebP without a frame")
    body = anmf[2]
    fx, fy = (int.from_bytes(body[i:i + 3], "little") * 2 for i in (0, 3))
    fw, fh = (int.from_bytes(body[i:i + 3], "little") + 1 for i in (6, 9))
    sub = _riff_chunks(body, 16, len(body))
    frame = b"".join(body[off:off + 8 + len(p) + (len(p) & 1)] for _, off, p in sub
                     if _ in (b"ALPH", b"VP8 ", b"VP8L"))
    if any(c == b"ALPH" for c, _, _ in sub):  # alpha needs the extended header
        vp8x = struct.pack("<4sIB3s3s3s", b"VP8X", 10, 0x10, b"\0\0\0",
                           (fw - 1).to_bytes(3, "little"), (fh - 1).to_bytes(3, "little"))
        frame = vp8x + frame
    still = b"RIFF" + struct.pack("<I", 4 + len(frame)) + b"WEBP" + frame
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[fy:fy + fh, fx:fx + fw] = decode_webp_rgba(still, name)[..., :3]
    return canvas


_DECODERS = {"JPEG": decode_jpeg, "PNG": _decode_png, "PPM": _decode_pnm,
             "PGM": _decode_pnm, "BMP": _decode_bmp, "GIF": _decode_gif, "WebP": _decode_webp}
