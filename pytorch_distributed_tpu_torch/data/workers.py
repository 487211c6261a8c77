"""What a spawned loader worker runs (``DataLoader(worker_type="process")``,
``data/loader.py``): the pool's initializer and the per-batch fetch.

numpy only: unpickling a dataset and these functions imports the dataset's
own modules and this one, never torch, so a worker that does not import its
parent's main module starts in a fraction of a second rather than the
seconds torch's import takes per process."""

from __future__ import annotations

import os

import numpy as np

_PROC_DATASET = None  # per-worker global, set by _process_init


def _process_init(dataset) -> None:
    global _PROC_DATASET
    # A data worker decodes on the host only: hide the cards from it, so
    # nothing it runs can create a CUDA context.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _PROC_DATASET = dataset


def _process_fetch(args):
    index, valid, seed, epoch = args
    if not valid:
        return None  # a padding slot
    rng = np.random.default_rng((seed, epoch, index))
    ds = _PROC_DATASET
    if hasattr(ds, "get"):
        return ds.get(index, rng)
    return ds[index]


def _process_fetch_chunk(chunk):
    """One task per worker per batch: fetch a whole contiguous chunk."""
    return [_process_fetch(a) for a in chunk]
