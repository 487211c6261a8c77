"""The msgpack format that ``flax.serialization`` writes, in pure Python.

The JAX package saves checkpoints with ``flax.serialization.to_bytes`` and
reads them with ``msgpack_restore``; the port reads and writes the same
bytes without importing flax or msgpack (neither is installed beside the
card).  The subset covered is what flax emits for a tree of dicts, lists,
Python scalars and arrays:

- nil, bool, int, float64, str, bin, array and map;
- ext 1, an ndarray: a nested msgpack ``[shape, dtype name, raw C-order
  bytes]``; ext 3, a numpy scalar, the same encoding at shape ``()``;
- arrays above ``MAX_CHUNK_SIZE`` bytes, split into
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces (msgpack caps one object at 2**31 - 1 bytes);
- ``bfloat16`` leaves, which numpy has no dtype for: written from a
  ``torch.bfloat16`` tensor and read back as one (a uint16 buffer viewed as
  bfloat16).

``to_bytes`` gives the same bytes as flax's for a tree with the same key
order.  Array payloads are never touched element by element: ``write``
streams each array's own buffer to the file, and ``read`` parses one
``bytearray`` of the file whose arrays are ``np.frombuffer`` views into it
(writable, so ``torch.from_numpy`` takes them without a copy).  Leaves come
back as numpy arrays (bfloat16 as torch tensors), ext 3 as numpy scalars,
msgpack arrays as lists, bin as bytes.
"""

from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, List, NamedTuple, Tuple, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_BF16 = "bfloat16"
_TORCH_TO_NUMPY = {
    torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}


# --------------------------------------------------------------------- encode

def to_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` for plain trees: dicts keep their order with
    ``str`` keys, lists and tuples become ``{"0": ..., "1": ...}``."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys do not have a unique string form: {list(tree)}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _host_array(x: Any) -> Tuple[np.ndarray, str]:
    """``(C-contiguous numpy array, flax dtype name)`` of an array leaf; a
    bfloat16 tensor travels as its int16 bit pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        if t.dtype not in _TORCH_TO_NUMPY:
            raise ValueError(f"unsupported tensor dtype {t.dtype}")
        return t.numpy(), np.dtype(_TORCH_TO_NUMPY[t.dtype]).name
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)   # (never for 0-d: it would make them 1-d)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization "
                         "of ndarrays.")
    return a, a.dtype.name


class _HostArray(NamedTuple):
    """An array leaf already on the host: a chunk of a split array."""
    array: np.ndarray
    name: str


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk(a: np.ndarray, name: str) -> dict:
    """flax's ``_chunk``: flat pieces of at most ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    chunks = [_HostArray(flat[i:i + size], name) for i in range(0, flat.size, size)]
    return {CHUNKED_KEY: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


class _Packer:
    """msgpack-python's packer (``use_bin_type=True``, ``strict_types=True``
    as flax calls it) over a list of parts: headers accumulate in a
    ``bytearray``, array payloads are appended as memoryviews of their own
    buffers."""

    def __init__(self):
        self.parts: List[Union[bytes, memoryview]] = []
        self._head = bytearray()

    def _raw(self, view: memoryview) -> None:
        if self._head:
            self.parts.append(bytes(self._head))
            self._head = bytearray()
        self.parts.append(view)

    def finish(self) -> List[Union[bytes, memoryview]]:
        if self._head:
            self.parts.append(bytes(self._head))
            self._head = bytearray()
        return self.parts

    def _int(self, n: int) -> None:
        w = self._head
        if 0 <= n < 0x80:
            w += struct.pack("B", n)
        elif -0x20 <= n < 0:
            w += struct.pack("b", n)
        elif 0x80 <= n <= 0xFF:
            w += struct.pack("BB", 0xCC, n)
        elif -0x80 <= n < 0:
            w += struct.pack(">Bb", 0xD0, n)
        elif 0xFF < n <= 0xFFFF:
            w += struct.pack(">BH", 0xCD, n)
        elif -0x8000 <= n < -0x80:
            w += struct.pack(">Bh", 0xD1, n)
        elif 0xFFFF < n <= 0xFFFFFFFF:
            w += struct.pack(">BI", 0xCE, n)
        elif -0x80000000 <= n < -0x8000:
            w += struct.pack(">Bi", 0xD2, n)
        elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
            w += struct.pack(">BQ", 0xCF, n)
        elif -0x8000000000000000 <= n < -0x80000000:
            w += struct.pack(">Bq", 0xD3, n)
        else:
            raise OverflowError("Integer value out of range")

    def _sized(self, n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> None:
        """Header of a str (fixstr/str8/16/32), array or map."""
        if n <= fix_max:
            self._head += struct.pack("B", fix + n)
        elif codes[0] and n <= 0xFF:
            self._head += struct.pack(">BB", codes[0], n)
        elif n <= 0xFFFF:
            self._head += struct.pack(">BH", codes[1], n)
        elif n <= 0xFFFFFFFF:
            self._head += struct.pack(">BI", codes[2], n)
        else:
            raise ValueError("object is too large for msgpack")

    def _bin_header(self, n: int) -> None:
        if n <= 0xFF:
            self._head += struct.pack(">BB", 0xC4, n)
        elif n <= 0xFFFF:
            self._head += struct.pack(">BH", 0xC5, n)
        elif n <= 0xFFFFFFFF:
            self._head += struct.pack(">BI", 0xC6, n)
        else:
            raise ValueError("Bin is too large")

    def _str(self, s: str) -> None:
        b = s.encode("utf-8")
        self._sized(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        self._head += b

    def _ext_header(self, n: int, code: int) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self._head += struct.pack("B", fixed[n])
        elif n <= 0xFF:
            self._head += struct.pack(">BB", 0xC7, n)
        elif n <= 0xFFFF:
            self._head += struct.pack(">BH", 0xC8, n)
        else:
            self._head += struct.pack(">BI", 0xC9, n)
        self._head += struct.pack("b", code)

    def _array(self, a: np.ndarray, name: str, code: int) -> None:
        """ext ``code`` around flax's ``_ndarray_to_bytes``: the packed
        ``(shape, dtype name, raw bytes)`` triple."""
        inner = _Packer()
        inner._sized(3, 0x90, 0x0F, (0, 0xDC, 0xDD))
        inner._sized(len(a.shape), 0x90, 0x0F, (0, 0xDC, 0xDD))
        for d in a.shape:
            inner._int(int(d))
        inner._str(name)
        inner._bin_header(a.nbytes)
        head = bytes(inner._head)
        self._ext_header(len(head) + a.nbytes, code)
        self._head += head
        if a.nbytes:
            self._raw(memoryview(a.reshape(-1).view(np.uint8)))

    def pack(self, obj: Any) -> None:
        if obj is None:
            self._head += b"\xc0"
        elif type(obj) is bool:
            self._head += b"\xc3" if obj else b"\xc2"
        elif type(obj) is int:
            self._int(obj)
        elif type(obj) in (bytes, bytearray):
            self._bin_header(len(obj))
            self._head += obj
        elif type(obj) is str:
            self._str(obj)
        elif type(obj) is float:
            self._head += struct.pack(">Bd", 0xCB, obj)
        elif type(obj) is dict:
            self._sized(len(obj), 0x80, 0x0F, (0, 0xDE, 0xDF))
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(obj, _HostArray):
            self._array(obj.array, obj.name, _EXT_NDARRAY)
        elif _is_array(obj):
            self._array(*_host_array(obj), _EXT_NDARRAY)
        elif isinstance(obj, np.generic):
            self._array(*_host_array(np.asarray(obj)), _EXT_NPSCALAR)
        else:
            raise TypeError(f"Cannot serialize {obj!r}")


def _chunk_leaves(tree: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``, on a copy: dict values (and
    a root array) larger than ``MAX_CHUNK_SIZE`` bytes become chunk dicts."""
    def big(x):
        if not _is_array(x):
            return None
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else x.size * x.dtype.itemsize)
        return _chunk(*_host_array(x)) if nbytes > MAX_CHUNK_SIZE else None

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            chunked = big(v)
            out[k] = chunked if chunked is not None else (
                _chunk_leaves(v) if isinstance(v, dict) else v)
        return out
    chunked = big(tree)
    return tree if chunked is None else chunked


def encode_parts(tree: Any) -> List[Union[bytes, memoryview]]:
    """``to_bytes(tree)`` as a list of parts whose concatenation it is: the
    array payloads are views of the leaves' own host buffers."""
    p = _Packer()
    p.pack(_chunk_leaves(to_state_dict(tree)))
    return p.finish()


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a plain tree."""
    return b"".join(encode_parts(tree))


def write_parts(parts: List[Union[bytes, memoryview]], f: BinaryIO) -> int:
    """Write ``encode_parts`` output into the open binary file ``f``; returns
    the bytes written."""
    n = 0
    for part in parts:
        f.write(part)
        n += len(part) if isinstance(part, bytes) else part.nbytes
    return n


def write(tree: Any, f: BinaryIO) -> int:
    """Stream ``to_bytes(tree)`` into ``f`` without joining it in memory."""
    return write_parts(encode_parts(tree), f)


# --------------------------------------------------------------------- decode

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data truncated: need {n} bytes at offset "
                             f"{self.pos} of {len(self.buf)}")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b not in sizes:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")
        n = self.unpack(sizes[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self._ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(data)
        shape, name, raw = inner._triple()
        if inner.pos != n:
            raise ValueError("trailing bytes inside an ndarray ext")
        arr = _from_buffer(shape, name, raw)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def _triple(self):
        """``[shape, dtype name, raw]`` of an ndarray ext, the raw payload as a
        view into the file's buffer (no copy)."""
        if self.unpack("B") != 0x93:
            raise ValueError("ndarray ext is not a 3-element array")
        shape = self.obj()
        name = self.obj()
        b = self.unpack("B")
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b not in lens or not isinstance(shape, list):
            raise ValueError("malformed ndarray ext")
        raw = self.take(self.unpack(lens[b]))
        return shape, name if isinstance(name, str) else str(name, "ascii"), raw


def _from_buffer(shape, name: str, raw: memoryview):
    dtype = np.dtype(np.int16 if name == _BF16 else name)
    count = 1
    for d in shape:
        count *= int(d)
    if count * dtype.itemsize != raw.nbytes:
        raise ValueError(f"ndarray ext of shape {shape} {name} carries {raw.nbytes} bytes")
    arr = (np.frombuffer(raw, dtype=dtype) if count else np.empty(0, dtype)).reshape(shape)
    if name == _BF16:
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).view(torch.bfloat16)
    return arr


def _unchunk(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk(v)
    return tree


def msgpack_restore(buf) -> Any:
    """``flax.serialization.msgpack_restore`` of ``buf`` (bytes, bytearray or
    a memoryview).  Arrays are views into ``buf``."""
    r = _Reader(buf)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the msgpack object")
    return _unchunk(tree)


def read_buffer(path: str) -> bytearray:
    """The file at ``path`` in one ``bytearray`` (one read, no other copy)."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise OSError(f"short read of '{path}'")
    return buf


def read(path: str) -> Any:
    """Decode the file at ``path``: one ``bytearray`` read, arrays viewing it."""
    return msgpack_restore(read_buffer(path))
