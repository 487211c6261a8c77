"""ctypes binding for the port's C++ data plane (``ptd_data.cpp``), the twin
of ``pytorch_distributed_tpu/data/native/binding.py`` with the same entry
points and ``_ABI``, plus the decoders the port needs in place of PIL
(``decode_jpeg``, ``decode_webp``, ``resize_bilinear``, ``png_unfilter``).

The library is built with g++ at first use into ``build/ptd_data/`` at the
root of the checkout (beside the CUDA kernels' ``build/torch_kernels/``).
It compiles against the jpeg62 and libwebp headers vendored under
``include/`` and links, by full path with an rpath, the first copy of each
library that the host has (``resolve_libraries``):

1. the system's ``libjpeg.so.62`` / ``libwebp.so.7`` (``ldconfig``, then the
   usual library directories);
2. else the copy that the Pillow wheel carries in its ``pillow.libs/``
   directory, found by path (PIL itself is never imported).

The file name carries a digest of the source, the headers, the flags and
the libraries linked, so a build directory copied from another host is
never reused against the wrong library.  Without a libjpeg the plane builds
``-nojpeg`` and JPEG raises naming the paths searched; without a libwebp,
``-nowebp`` and WebP raises alike.  There is no numpy fallback: a failed
build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import importlib.util
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "ptd_data.cpp"
INCLUDE_DIR = _HERE / "include"
BUILD_DIR = _HERE.parents[2] / "build" / "ptd_data"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI = 3
# name -> (soname searched on the system, file pattern in pillow.libs/)
LIBRARIES = {"jpeg": ("libjpeg.so.62", "libjpeg-*.so.62*"),
             "webp": ("libwebp.so.7", "libwebp-*.so.7*")}
_SYSTEM_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64", "/lib64",
                "/usr/lib", "/lib", "/usr/local/lib")
AUTO = "auto"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_resolved: Optional[Dict[str, Optional[str]]] = None
_searched: Dict[str, List[str]] = {}


def _ldconfig_paths(soname: str) -> List[str]:
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.rsplit("=>", 1)[1].strip() for line in out.stdout.splitlines()
            if line.strip().startswith(soname + " ") and "x86-64" in line and "=>" in line]


def pillow_libs_dir() -> Optional[Path]:
    """The Pillow wheel's bundled-library directory, found without importing
    PIL, or None."""
    try:
        spec = importlib.util.find_spec("PIL")
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.origin:
        return None
    d = Path(spec.origin).resolve().parents[1] / "pillow.libs"
    return d if d.is_dir() else None


def _resolve(name: str) -> Optional[str]:
    """The first ``name`` library found: the system's, else Pillow's copy;
    records every place searched in ``_searched[name]``."""
    soname, pattern = LIBRARIES[name]
    tried = [f"ldconfig -p: {soname}"]
    hits = _ldconfig_paths(soname)
    for d in _SYSTEM_DIRS:
        tried.append(f"{d}/{soname}")
        if os.path.exists(f"{d}/{soname}"):
            hits.append(f"{d}/{soname}")
    pil = pillow_libs_dir()
    tried.append(f"{pil}/{pattern}" if pil else "pillow.libs/ (no Pillow wheel found)")
    if pil:
        hits += sorted(glob.glob(str(pil / pattern)))
    _searched[name] = tried
    return os.path.realpath(hits[0]) if hits else None


def resolve_libraries() -> Dict[str, Optional[str]]:
    """``{"jpeg": path or None, "webp": path or None}``: the libraries the
    default plane links (resolved once per process; None where it builds
    without one)."""
    global _resolved
    if _resolved is None:
        _resolved = {name: _resolve(name) for name in LIBRARIES}
    return dict(_resolved)


def searched(name: str) -> str:
    """Where the default resolution looked for library ``name``."""
    resolve_libraries()
    return "; ".join(_searched.get(name, []))


def _target(libs: Dict[str, Optional[str]]) -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    for hdr in sorted(INCLUDE_DIR.rglob("*.h")):
        h.update(hdr.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    tags = ""
    for name in sorted(libs):
        path = libs[name]
        h.update(f"{name}={path}:{os.path.getsize(path) if path else 0}".encode())
        tags += "" if path else f"-no{name}"
    return BUILD_DIR / f"libptd_data-{h.hexdigest()[:16]}{tags}.so"


def build(jpeg: Optional[str] = AUTO, webp: Optional[str] = AUTO) -> Path:
    """The plane for the current source linked against ``jpeg`` and
    ``webp`` (library paths; ``AUTO`` resolves them as ``resolve_libraries``
    does, None builds without), built if missing.  A file lock keeps
    concurrent processes from building twice; raises with g++'s output if
    the build fails."""
    auto = resolve_libraries()
    libs = {"jpeg": auto["jpeg"] if jpeg == AUTO else jpeg,
            "webp": auto["webp"] if webp == AUTO else webp}
    for name, path in libs.items():
        if path is not None and not os.path.isfile(path):
            raise FileNotFoundError(f"no {name} library at {path}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _target(libs)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        cmd = ["g++", *GXX_FLAGS, f"-I{INCLUDE_DIR}", "-o", None, str(_SRC), "-lpthread"]
        for name, path in libs.items():
            if path is None:
                cmd.append(f"-DPTD_NO_{name.upper()}")
            else:
                cmd += [path, f"-Wl,--disable-new-dtags,-rpath,{os.path.dirname(path)}"]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd[cmd.index(None)] = str(tmp)
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"could not build the C++ data plane: {' '.join(cmd)}: {e}"
                               ) from e
        if res.returncode != 0:
            raise RuntimeError(f"could not build the C++ data plane {_SRC}: {' '.join(cmd)} "
                               f"exited {res.returncode}:\n{res.stderr}")
        os.replace(tmp, so)
        return so


def open_library(path: Path) -> ctypes.CDLL:
    """Load one built plane and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    if lib.ptd_data_abi_version() != _ABI:
        raise RuntimeError(f"{path} reports ABI {lib.ptd_data_abi_version()}, the binding "
                           f"expects {_ABI}")
    return lib


def _load() -> ctypes.CDLL:
    """The default plane.  A file under its name that does not load (say, a
    damaged copy) is deleted and built again, once."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                _lib = open_library(so)
            except OSError:
                so.unlink(missing_ok=True)
                _lib = open_library(build())
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
            ("ptd_gif_lzw", [p, i64, i32, p, i64], i64),
            ("ptd_webp_info", [p, i64, p], i32),
            ("ptd_decode_webp_rgba", [p, i64, p, i64, i64], i32),
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
        raise _no_library("decode_crop_resize_batch", "libjpeg")
    return (out, failed.astype(bool)) if return_failed else out


def _no_library(name: str, what: str) -> RuntimeError:
    return RuntimeError(f"{name}: the C++ data plane was built without {what} (searched: "
                        f"{searched(what[3:])}), so the port cannot decode this file on "
                        "this host")


def decode_jpeg(blob: bytes, name: str = "<bytes>", lib: Optional[ctypes.CDLL] = None
                ) -> np.ndarray:
    """One whole JPEG -> uint8 [h, w, 3] RGB, decoded as PIL's
    ``Image.open(...).convert("RGB")`` decodes it (ISLOW, fancy upsampling,
    gray replicated, 4-component files as inverted CMYK).  ``lib``: a plane
    from ``open_library`` (default: the default build)."""
    lib = lib or _load()
    buf = np.frombuffer(blob, np.uint8)
    info = np.zeros(3, np.int32)
    rc = lib.ptd_jpeg_header(buf.ctypes.data, len(buf), info.ctypes.data)
    if rc < 0:
        raise _no_library(name, "libjpeg")
    if rc:
        raise ValueError(f"{name}: not a readable JPEG header")
    w, h, comps = (int(v) for v in info)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.ptd_decode_jpeg_rgb(buf.ctypes.data, len(buf), out.ctypes.data, w, h)
    if rc:
        why = {1: "corrupt JPEG data", 3: f"{comps} components (1, 3 or 4 decode)"}
        raise ValueError(f"{name}: {why.get(rc, f'decode error {rc}')}")
    return out


def webp_info(blob: bytes, name: str = "<bytes>") -> tuple:
    """``(width, height, has_alpha, has_animation)`` of one WebP bitstream."""
    buf = np.frombuffer(blob, np.uint8)
    info = np.zeros(4, np.int32)
    rc = _load().ptd_webp_info(buf.ctypes.data, len(buf), info.ctypes.data)
    if rc < 0:
        raise _no_library(name, "libwebp")
    if rc:
        raise ValueError(f"{name}: not a readable WebP header")
    return tuple(int(v) for v in info)


def decode_webp_rgba(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """One still WebP -> uint8 [h, w, 4] RGBA (straight alpha)."""
    w, h, _, animated = webp_info(blob, name)
    if animated:
        raise ValueError(f"{name}: animated WebP: decode one frame at a time")
    buf = np.frombuffer(blob, np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    if _load().ptd_decode_webp_rgba(buf.ctypes.data, len(buf), out.ctypes.data, w, h):
        raise ValueError(f"{name}: corrupt WebP data")
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


def gif_lzw(data: bytes, min_code_size: int, npix: int) -> np.ndarray:
    """GIF LZW image data (sub-blocks joined) -> up to ``npix`` uint8
    indices; shorter when the stream ends early."""
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(npix, np.uint8)
    n = _load().ptd_gif_lzw(buf.ctypes.data if len(buf) else None, len(buf), min_code_size,
                            out.ctypes.data, npix)
    if n < 0:
        raise ValueError("corrupt GIF LZW data")
    return out[:n]
