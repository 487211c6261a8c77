"""Batching loader and device feeder, the port of
``pytorch_distributed_tpu/data/loader.py``.

- ``DataLoader`` iterates the sampler's shard as static-shape numpy
  batches: a trailing partial batch is zero-padded and carries a 0/1
  ``weights`` mask, so padding contributes nothing to loss and metrics
  (exact evaluation).  Its ``batch_mode`` (f32, u8_host, u8_wire), the
  batch-level flip stream, the native JPEG batch decode with corrupt-file
  masking, the ``(seed, epoch, index)`` per-sample rng and the thread or
  spawn-process workers are the JAX loader's.
- ``DeviceFeeder`` turns host batches into tensors on the device, 2 deep: a
  background thread pins each batch and copies it to the card on a side
  CUDA stream, normalizes a uint8 batch there, and records an event; the
  consumer's stream waits on that event.  On the CPU it only wraps the
  arrays (normalizing a uint8 batch).
"""

from __future__ import annotations

import contextlib
import pickle
import queue
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.sampler import DistributedShardSampler
from pytorch_distributed_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from pytorch_distributed_tpu_torch.data.workers import _process_fetch_chunk, _process_init

Batch = Dict[str, np.ndarray]


class DataLoader:
    """Iterates this rank's shard as padded, masked numpy batches
    ``{"images" [B, H, W, 3], "labels" [B] int32, "weights" [B] f32}``.

    ``batch_mode``:

    - ``"f32"``     — per-sample transforms yield normalized float32;
    - ``"u8_host"`` — transforms yield uint8; flip + normalize run at batch
                      level in the C++ data plane;
    - ``"u8_wire"`` — transforms yield uint8; flip runs on the host, the
                      batch crosses to the card as uint8 (4x fewer bytes)
                      and ``DeviceFeeder`` normalizes it there.

    ``random_flip`` applies the train stack's horizontal flip in the u8
    modes from the ``(seed, epoch, batch, 1)`` stream (in f32 mode the flip
    lives in the per-sample transform).  ``worker_type``: ``"thread"`` or
    ``"process"`` (a persistent spawn pool fetching one contiguous chunk of
    each batch per worker; the dataset must pickle, and the workers never
    touch CUDA).
    """

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[DistributedShardSampler] = None, num_workers: int = 2,
                 drop_last: bool = False, seed: int = 0, batch_mode: str = "f32",
                 random_flip: bool = False, worker_type: str = "thread"):
        if batch_mode not in ("f32", "u8_host", "u8_wire"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        if worker_type not in ("thread", "process"):
            raise ValueError(f"unknown worker_type {worker_type!r}")
        self.worker_type = worker_type
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedShardSampler(len(dataset), shuffle=False,
                                                          seed=seed)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.batch_mode = batch_mode
        self.random_flip = random_flip
        self._pool = None      # persistent spawn pool (process worker_type)
        self._pool_key = None

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, index: int, valid: int):
        if not valid:
            return None  # a padding slot
        rng = np.random.default_rng((self.seed, self.sampler.epoch, int(index)))
        if hasattr(self.dataset, "get"):
            return self.dataset.get(int(index), rng)
        return self.dataset[int(index)]

    def _assemble_native(self, samples):
        """Batch the ("jpeg", blob, params, label) / ("u8", arr, None, label)
        samples of a native_decode dataset: one C++ call decodes, crops and
        resizes every JPEG of the batch.  Returns ``(images, labels, dead)``,
        ``dead`` the batch slots whose JPEG failed to decode (the caller
        zeroes their weights)."""
        from pytorch_distributed_tpu_torch.data.native import decode_crop_resize_batch

        size = self.dataset.image_size
        images = np.zeros((self.batch_size, size, size, 3), np.uint8)
        labels = np.zeros(self.batch_size, dtype=np.int32)
        blobs, params, slots, dead = [], [], [], []
        for i, s in enumerate(samples):
            if s is None:
                continue
            kind, payload, p, label = s
            labels[i] = label
            if kind == "jpeg":
                slots.append(i)
                blobs.append(payload)
                params.append(p)
            else:
                images[i] = payload
        if blobs:
            params_arr = np.stack(params) if params[0] is not None else None
            decoded, failed = decode_crop_resize_batch(blobs, size, params=params_arr,
                                                       return_failed=True)
            images[slots] = decoded
            if failed.any():
                dead = [slots[j] for j in np.nonzero(failed)[0]]
                warnings.warn(f"{len(dead)} corrupt JPEG(s) in batch — samples masked out "
                              "of loss/metrics", stacklevel=2)
        return images, labels, dead

    def _batch_indices(self, indices, valid, b: int):
        lo, hi = b * self.batch_size, (b + 1) * self.batch_size
        idx, val = indices[lo:hi], valid[lo:hi]
        pad = self.batch_size - len(idx)  # pad the trailing batch to the static size
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
            val = np.concatenate([val, np.zeros(pad, dtype=val.dtype)])
        return idx, val

    def _assemble(self, b: int, val, samples) -> Batch:
        """Samples → one padded, masked batch (both worker types)."""
        if getattr(self.dataset, "native_decode", False):
            if self.batch_mode == "f32":
                raise TypeError("native_decode datasets produce uint8 batches; use "
                                "batch_mode 'u8_host' or 'u8_wire'")
            images, labels, dead = self._assemble_native(samples)
            if dead:
                val = val.copy()
                val[dead] = 0
        else:
            proto = next(s for s in samples if s is not None)
            if self.batch_mode != "f32" and proto[0].dtype != np.uint8:
                raise TypeError(f"batch_mode {self.batch_mode!r} needs uint8 samples (use "
                                f"the *_transform_u8 stacks), got {proto[0].dtype}")
            images = np.zeros((self.batch_size,) + proto[0].shape,
                              dtype=np.uint8 if self.batch_mode != "f32" else np.float32)
            labels = np.zeros(self.batch_size, dtype=np.int32)
            for i, s in enumerate(samples):
                if s is not None:
                    images[i] = s[0]
                    labels[i] = s[1]
        if self.batch_mode != "f32":
            flip = None
            if self.random_flip:
                flip_rng = np.random.default_rng((self.seed, self.sampler.epoch, b, 1))
                flip = (flip_rng.random(self.batch_size) < 0.5).astype(np.uint8)
            if self.batch_mode == "u8_host":
                from pytorch_distributed_tpu_torch.data.native import normalize_batch

                images = normalize_batch(images, IMAGENET_MEAN, IMAGENET_STD, flip=flip)
            elif flip is not None:  # u8_wire: flip on the host, uint8 out
                fidx = np.nonzero(flip)[0]
                images[fidx] = images[fidx, :, ::-1, :]
        return {"images": images, "labels": labels, "weights": val.astype(np.float32)}

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0) -> Iterator[Batch]:
        """Iterate from batch ``start`` of this epoch's shard: the
        step-granular resume path.  The sampler's (seed, epoch) permutation
        is recomputed and the first ``start`` batches are skipped by index
        arithmetic (nothing fetched), so the stream continues exactly where
        the checkpointed run left off."""
        indices, valid = self.sampler.shard()
        nb = len(self)
        if not 0 <= start <= nb:
            raise ValueError(f"resume step {start} out of range for {nb} batches/epoch")
        if self.worker_type == "process":
            yield from self._iter_process(indices, valid, nb, start)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(start, nb):
                idx, val = self._batch_indices(indices, valid, b)
                yield self._assemble(b, val, list(pool.map(self._fetch, idx, val)))

    def _ensure_pool(self):
        """The spawn pool persists across epochs, rebuilt when ``dataset`` is
        rebound to another object or the worker count changes.  The key
        holds a strong reference to the dataset and compares by identity, so
        a freed-then-reallocated object cannot alias it.  Workers hold a
        pickled snapshot of the dataset: after mutating it in place, call
        ``close()`` to ship it again."""
        import multiprocessing as mp

        if (self._pool is not None and self._pool_key is not None
                and self._pool_key[0] is self.dataset
                and self._pool_key[1] == self.num_workers):
            return self._pool
        self.close()
        ctx = mp.get_context("spawn")
        _install_pool_reaper()  # after multiprocessing's own atexit hook: ours runs first
        with _spawn_without_main(self.dataset):
            self._pool = ctx.Pool(self.num_workers, initializer=_process_init,
                                  initargs=(self.dataset,))
        _LIVE_POOLS.append(self._pool)
        self._pool_key = (self.dataset, self.num_workers)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            if self._pool in _LIVE_POOLS:
                _LIVE_POOLS.remove(self._pool)
            self._pool = None
            self._pool_key = None

    def __del__(self):  # best effort; close() is the deterministic path
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- the interpreter may be tearing down
            pass

    def _iter_process(self, indices, valid, nb: int, start: int = 0) -> Iterator[Batch]:
        """Worker processes for the per-sample fetch.  Spawn, not fork: a
        threaded parent (torch's pools, the feeder) can deadlock forked
        children.  Dispatch is by batch: each worker fetches one contiguous
        chunk of the batch per task, one pickle round trip per worker per
        batch."""
        pool = self._ensure_pool()
        W = self.num_workers
        for b in range(start, nb):
            idx, val = self._batch_indices(indices, valid, b)
            args = [(int(i), int(v), self.seed, self.sampler.epoch) for i, v in zip(idx, val)]
            bounds = [(len(args) * w // W, len(args) * (w + 1) // W) for w in range(W)]
            chunks = [args[lo:hi] for lo, hi in bounds if hi > lo]
            samples = [s for chunk in pool.map(_process_fetch_chunk, chunks) for s in chunk]
            yield self._assemble(b, val, samples)


@contextlib.contextmanager
def _spawn_without_main(payload):
    """Inside: a process that ``multiprocessing`` spawns imports what it
    unpickles (``workers.py`` and the dataset's modules, numpy only) and
    does not first run the parent's main module, which it finds by
    ``__main__.__spec__`` under ``python -m`` and else by its ``__file__``:
    a recipe's main module imports torch and the whole port, seconds a
    worker.  Where ``payload`` pickles a reference to ``__main__`` (a
    dataset class defined in the user's script), the main module runs as
    usual."""
    main = sys.modules["__main__"]
    if b"__main__" in pickle.dumps(payload):
        yield
        return
    spec, path = getattr(main, "__spec__", None), main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__spec__ = spec
        if path is not None:
            main.__file__ = path


_LIVE_POOLS: list = []
_REAPER_INSTALLED = False


def _install_pool_reaper() -> None:
    """Terminate any still-live worker pool at interpreter exit.  atexit
    hooks run last-in first-out, so registering ours after multiprocessing
    registered its own makes pools die before the stdlib's exit machinery
    would block joining their queue threads."""
    global _REAPER_INSTALLED
    if _REAPER_INSTALLED:
        return
    import atexit
    # multiprocessing.util registers its atexit hook on import, which Pool()
    # does lazily: import it first so that our hook is the later one.
    import multiprocessing.util  # noqa: F401

    def _reap():
        for p in list(_LIVE_POOLS):
            try:
                p.terminate()
                p.join()
            except Exception:  # noqa: BLE001 -- exit path, best effort
                pass
        _LIVE_POOLS.clear()

    atexit.register(_reap)
    _REAPER_INSTALLED = True


def _uint8_images(tensors: Dict[str, torch.Tensor]) -> bool:
    images = tensors.get("images")
    return images is not None and images.dtype == torch.uint8


class DeviceFeeder:
    """Host batches in, ``{key: tensor on device}`` out, ``prefetch`` deep
    (image batches, and the LM's ``{"tokens": ...}`` batches).

    A producer thread pulls host batches, converts them to pinned tensors
    and, on a CUDA device, issues their copies on a side stream, normalizes
    a uint8 image batch there (``(x / 255 - mean) / std`` in f32, the JAX
    feeder's on-device normalize) and records an event; the consumer makes
    its current stream wait on the event, so it waits on the copy and the
    normalization together, and marks the tensors as used on it
    (``record_stream``), so the caching allocator does not reuse their
    memory early.  Exceptions in the producer surface at the consumer.
    ``wait_s`` sums the time the consumer sat waiting for a batch (the host
    share the prefetch did not hide).
    """

    def __init__(self, device, prefetch: int = 2):
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.wait_s = 0.0
        self._norm = None  # (mean, std) on the device, made at the first uint8 batch

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        if self._norm is None:
            self._norm = tuple(torch.from_numpy(a).to(self.device)
                               for a in (IMAGENET_MEAN, IMAGENET_STD))
        mean, std = self._norm
        return (images.float() / 255.0 - mean) / std

    def _put(self, batch: Batch, stream):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if stream is None:
            if _uint8_images(tensors):
                tensors["images"] = self._normalize(tensors["images"])
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in tensors.items()}
            if _uint8_images(out):
                out["images"] = self._normalize(out["images"])
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __call__(self, host_iter) -> Iterator[Dict[str, torch.Tensor]]:
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop, dead = object(), threading.Event()

        def offer(item) -> bool:
            # Put with a liveness check, so an abandoned consumer cannot
            # leave this thread blocked on a full queue.
            while not dead.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in host_iter:
                    if dead.is_set() or not offer(self._put(batch, stream)):
                        return
                offer(stop)
            except BaseException as e:  # noqa: BLE001 -- re-raised at the consumer
                offer(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                tensors, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in tensors.values():
                        v.record_stream(current)
                yield tensors
        finally:
            dead.set()
            t.join(timeout=5.0)
