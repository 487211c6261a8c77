"""Batching loader and device feeder, the port of
``pytorch_distributed_tpu/data/loader.py``.

- ``DataLoader`` iterates the sampler's shard as static-shape numpy
  batches: a trailing partial batch is zero-padded and carries a 0/1
  ``weights`` mask, so padding contributes nothing to loss and metrics (exact
  evaluation).  Samples are fetched by a pool of worker threads (``-j``).
  This is the JAX loader's ``batch_mode="f32"`` without augmentation; the
  transforms, the uint8 wire modes and worker processes wait for
  ROADMAP.md item A17.
- ``DeviceFeeder`` turns host batches into tensors on the device, 2 deep: a
  background thread assembles each batch, pins it, and copies it to the card
  on a side CUDA stream; the consumer's stream waits on that copy's event.
  On the CPU it only wraps the arrays.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.sampler import DistributedShardSampler

Batch = Dict[str, np.ndarray]


class DataLoader:
    """Iterates this rank's shard as padded, masked numpy batches
    ``{"images" [B, H, W, 3] f32, "labels" [B] int32, "weights" [B] f32}``."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[DistributedShardSampler] = None, num_workers: int = 2,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedShardSampler(len(dataset), shuffle=False)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, index: int, valid: int):
        return self.dataset[int(index)] if valid else None  # None: a padding slot

    def _batch_indices(self, indices, valid, b: int):
        lo, hi = b * self.batch_size, (b + 1) * self.batch_size
        idx, val = indices[lo:hi], valid[lo:hi]
        pad = self.batch_size - len(idx)  # pad the trailing batch to the static size
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
            val = np.concatenate([val, np.zeros(pad, dtype=val.dtype)])
        return idx, val

    def _assemble(self, val, samples) -> Batch:
        proto = next(s for s in samples if s is not None)
        images = np.zeros((self.batch_size,) + proto[0].shape, dtype=np.float32)
        labels = np.zeros(self.batch_size, dtype=np.int32)
        for i, s in enumerate(samples):
            if s is not None:
                images[i] = s[0]
                labels[i] = s[1]
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
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(start, nb):
                idx, val = self._batch_indices(indices, valid, b)
                yield self._assemble(val, list(pool.map(self._fetch, idx, val)))


class DeviceFeeder:
    """Host batches in, ``{key: tensor on device}`` out, ``prefetch`` deep.

    A producer thread pulls host batches, converts them to pinned tensors
    and, on a CUDA device, issues their copies on a side stream and records
    an event; the consumer makes its current stream wait on the event and
    marks the tensors as used on it (``record_stream``), so the caching
    allocator does not reuse their memory early.  Exceptions in the producer
    surface at the consumer.  ``wait_s`` sums the time the consumer sat
    waiting for a batch (the host share the prefetch did not hide).
    """

    def __init__(self, device, prefetch: int = 2):
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.wait_s = 0.0

    def _put(self, batch: Batch, stream):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if stream is None:
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in tensors.items()}
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
