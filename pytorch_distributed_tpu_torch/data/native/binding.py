"""ctypes binding for the port's C++ data plane (``ptd_data.cpp``), the twin
of ``pytorch_distributed_tpu/data/native/binding.py`` with the same entry
points and ``_ABI``, plus the decoders the port needs in place of PIL
(``decode_jpeg``, ``resize_bilinear``, ``png_unfilter``).

The library is built with g++ at first use into ``build/ptd_data/`` at the
root of the checkout (beside the CUDA kernels' ``build/torch_kernels/``);
its file name carries a digest of the source and the flags, so an edited
source builds anew.  The build links libjpeg where the host has it; without
libjpeg it builds with ``-DPTD_NO_JPEG`` and ``jpeg_native_available()`` is
false.  There is no numpy fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "ptd_data.cpp"
BUILD_DIR = _HERE.parents[2] / "build" / "ptd_data"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI = 3
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _targets():
    """``(with libjpeg, without)`` library paths for the current source."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    stem = f"libptd_data-{h.hexdigest()[:16]}"
    return BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}-nojpeg.so"


def _build() -> Path:
    """The library for the current source, built if missing: with libjpeg,
    else without it.  A file lock keeps concurrent processes from building
    twice; raises with g++'s output if neither build succeeds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        targets = _targets()
        for so in targets:
            if so.exists():
                return so
        logs = []
        for so, extra in zip(targets, (["-ljpeg"], ["-DPTD_NO_JPEG"])):
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread", *extra]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                logs.append(f"{' '.join(cmd)}: {e}")
                continue
            if res.returncode == 0:
                os.replace(tmp, so)
                return so
            logs.append(f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}")
        raise RuntimeError("could not build the C++ data plane " + str(_SRC) + ":\n"
                           + "\n".join(logs))


def _open() -> ctypes.CDLL:
    """Load the built library.  A library built on another host (a copied
    build directory) may link a libjpeg this host lacks: it is deleted and
    built again, once."""
    so = _build()
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        so.unlink(missing_ok=True)
        return ctypes.CDLL(str(_build()))


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _open()
            _declare(lib)
            if lib.ptd_data_abi_version() != _ABI:
                raise RuntimeError(f"{_SRC} reports ABI {lib.ptd_data_abi_version()}, the "
                                   f"binding expects {_ABI}")
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, argtypes, restype in (
            ("ptd_normalize_batch", [p, p, i64, i64, i64, p, p, p, i32], None),
            ("ptd_decode_crop_resize_batch", [p, p, i64, p, i32, i32, i32, p, p, i32], i32),
            ("ptd_jpeg_header", [p, i64, p], i32),
            ("ptd_decode_jpeg_rgb", [p, i64, p, i64, i64], i32),
            ("ptd_resize_bilinear", [p, i64, i64, i64, p, i64, i64], None),
            ("ptd_png_unfilter", [p, p, i64, i64, i32], i32),
            ("ptd_data_abi_version", [], i32)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def normalize_batch(images_u8: np.ndarray, mean: np.ndarray, std: np.ndarray,
                    flip: Optional[np.ndarray] = None, n_threads: int = 0) -> np.ndarray:
    """(u8 NHWC batch / 255 - mean) / std, with optional per-sample hflip."""
    if images_u8.dtype != np.uint8 or images_u8.ndim != 4 or images_u8.shape[3] != 3:
        raise ValueError(f"normalize_batch takes a uint8 [n, h, w, 3] batch, got "
                         f"{images_u8.dtype} {images_u8.shape}")
    n, h, w, c = images_u8.shape
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    images_u8 = np.ascontiguousarray(images_u8)
    out = np.empty((n, h, w, c), dtype=np.float32)
    flip_arr = np.ascontiguousarray(flip, dtype=np.uint8) if flip is not None else None
    if flip_arr is not None and flip_arr.shape != (n,):
        raise ValueError(f"flip must be [{n}], got {flip_arr.shape}")
    _load().ptd_normalize_batch(
        images_u8.ctypes.data, out.ctypes.data, n, h, w, mean.ctypes.data, std.ctypes.data,
        flip_arr.ctypes.data if flip_arr is not None else None, n_threads)
    return out


def jpeg_native_available() -> bool:
    """True when the library was built against libjpeg."""
    empty = np.zeros(1, np.int64)
    # A PTD_NO_JPEG build returns -1 unconditionally; probe with n=0.
    return _load().ptd_decode_crop_resize_batch(
        None, empty.ctypes.data, 0, None, 1, 1, 1, None, None, 1) == 0


def decode_crop_resize_batch(blobs, out_size: int, params: Optional[np.ndarray] = None,
                             resize_short: int = 0, n_threads: int = 0,
                             return_failed: bool = False):
    """Batch JPEG decode + crop + bilinear resize -> uint8 [n, S, S, 3], the
    JAX plane's function: ``params`` [n, 4] f32 train crop draws (area_frac,
    log_ratio, u, v) for single-attempt RandomResizedCrop, or None for eval
    (short side ``resize_short`` + center crop).  Corrupt blobs come back as
    zeroed slots; ``return_failed=True`` also returns the failure mask."""
    lib = _load()
    n = len(blobs)
    offsets = np.zeros(n + 1, np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    concat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    failed = np.zeros(n, np.uint8)
    p = None
    if params is not None:
        p = np.ascontiguousarray(params, dtype=np.float32)
        if p.shape != (n, 4):
            raise ValueError(f"params must be [{n}, 4], got {p.shape}")
    rc = lib.ptd_decode_crop_resize_batch(
        concat.ctypes.data if n else None, offsets.ctypes.data, n,
        p.ctypes.data if p is not None else None, out_size, out_size,
        resize_short or int(out_size * 256 / 224), out.ctypes.data, failed.ctypes.data,
        n_threads)
    if rc < 0:
        raise RuntimeError("native library built without libjpeg")
    return (out, failed.astype(bool)) if return_failed else out


def decode_jpeg(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """One whole JPEG -> uint8 [h, w, 3] RGB, decoded as PIL's
    ``Image.open(...).convert("RGB")`` decodes it (ISLOW, fancy upsampling,
    gray replicated, 4-component files as inverted CMYK)."""
    lib = _load()
    buf = np.frombuffer(blob, np.uint8)
    info = np.zeros(3, np.int32)
    rc = lib.ptd_jpeg_header(buf.ctypes.data, len(buf), info.ctypes.data)
    if rc < 0:
        raise RuntimeError(f"{name}: the C++ data plane was built without libjpeg, so the "
                           "port cannot decode JPEG files on this host")
    if rc:
        raise ValueError(f"{name}: not a readable JPEG header")
    w, h, comps = (int(v) for v in info)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.ptd_decode_jpeg_rgb(buf.ctypes.data, len(buf), out.ctypes.data, w, h)
    if rc:
        why = {1: "corrupt JPEG data", 3: f"{comps} components (1, 3 or 4 decode)"}
        raise ValueError(f"{name}: {why.get(rc, f'decode error {rc}')}")
    return out


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """PIL's ``Image.resize((w, h), BILINEAR)`` of a uint8 [h, w, c] array,
    bit for bit; ``size`` is ``(width, height)`` as PIL takes it."""
    if img.dtype != np.uint8 or img.ndim != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"resize_bilinear takes uint8 [h, w, c<=4], got {img.dtype} "
                         f"{img.shape}")
    ow, oh = (int(s) for s in size)
    ih, iw, c = img.shape
    if ow < 1 or oh < 1 or iw < 1 or ih < 1:
        raise ValueError(f"cannot resize {iw}x{ih} to {ow}x{oh}")
    img = np.ascontiguousarray(img)
    out = np.empty((oh, ow, c), np.uint8)
    _load().ptd_resize_bilinear(img.ctypes.data, ih, iw, c, out.ctypes.data, oh, ow)
    return out


def png_unfilter(data: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``data`` holds ``height`` rows of one
    filter byte plus ``rowbytes``; returns uint8 [height, rowbytes]."""
    if len(data) < height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, {height} rows of "
                         f"{rowbytes + 1} need {height * (rowbytes + 1)}")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    row = _load().ptd_png_unfilter(buf.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if row:
        raise ValueError(f"unknown PNG filter type {buf[(row - 1) * (rowbytes + 1)]} in row "
                         f"{row - 1}")
    return out
