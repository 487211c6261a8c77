"""Checkpoint integrity primitives: sha256 sidecars, atomic writes, and
bounded-backoff I/O retries.  A copy of ``pytorch_distributed_tpu/ft/integrity.py``:
the sidecar bytes are the same, so each package verifies the other's files.

Every checkpoint file carries a ``<name>.sha256`` sidecar written after the
payload's atomic rename; verification happens *before* deserialization, so
a flipped bit or a torn write is reported as corruption, and the loader can
fall back to the previous retained checkpoint instead of crashing.  One
transient I/O error on a shared filesystem is retried, not fatal.

Stdlib-only, as its JAX twin.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Optional, Tuple, Type

SIDECAR_SUFFIX = ".sha256"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed sidecar verification or deserialization."""


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def write_sidecar(path: str) -> str:
    """Write ``<path>.sha256`` atomically (tmp + rename) and return it.

    Written AFTER the payload's own atomic rename: a crash between the two
    leaves a payload without a sidecar (treated as legacy/unverified), never
    a sidecar pointing at a torn payload."""
    digest = file_sha256(path)
    side = sidecar_path(path)
    tmp = side + ".tmp"
    with open(tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(tmp, side)
    return side


def read_sidecar(path: str) -> Optional[str]:
    """The recorded digest for ``path``, or None when no sidecar exists."""
    side = sidecar_path(path)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return f.read().strip() or None


def verify_sidecar(path: str) -> Optional[bool]:
    """True = digest matches, False = mismatch (corrupt/truncated/stale),
    None = no sidecar to check (pre-FT legacy checkpoint)."""
    want = read_sidecar(path)
    if want is None:
        return None
    return file_sha256(path) == want


def check_integrity(path: str) -> None:
    """Raise ``CheckpointCorruptError`` on a failed sidecar check; silent on
    a match or a missing sidecar (legacy files stay loadable)."""
    ok = verify_sidecar(path)
    if ok is False:
        raise CheckpointCorruptError(
            f"checkpoint '{path}' fails sha256 sidecar verification "
            f"(expected {read_sidecar(path)}, file hashes to "
            f"{file_sha256(path)}): corrupted or truncated on disk"
        )


def replace_with_sidecar(src: str, dst: str) -> None:
    """``os.replace(src, dst)`` moving the sidecar along (if any) — keeps a
    rotated ``checkpoint.prev.msgpack`` independently verifiable."""
    side_src = sidecar_path(src)
    has_side = os.path.exists(side_src)
    os.replace(src, dst)
    if has_side:
        os.replace(side_src, sidecar_path(dst))


def retrying(
    fn: Callable,
    attempts: int = 3,
    base_delay: float = 0.05,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Run ``fn()`` with bounded exponential backoff (``base_delay * 2**k``
    between attempts) — the flaky-shared-filesystem wrapper for checkpoint
    I/O.  Retries only ``exceptions`` (default OSError: NFS ESTALE/EIO
    class); anything else — including ``CheckpointCorruptError``, which
    retrying cannot fix — propagates immediately.  Re-raises the last error
    once ``attempts`` are exhausted."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for k in range(attempts):
        try:
            return fn()
        except exceptions as e:
            if k == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(k, e)
            sleep(base_delay * (2 ** k))
