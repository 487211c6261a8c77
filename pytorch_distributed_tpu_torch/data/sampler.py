"""Deterministic per-rank index sharding with epoch reshuffle, a copy of
``pytorch_distributed_tpu/data/sampler.py`` (numpy only, so the same
permutation on both sides; the port's image path runs it with world 1).

Capability parity with ``torch.utils.data.distributed.DistributedSampler``
as the reference uses it (reference distributed.py:174-175,190-195 and the
``set_epoch`` calls at :202-203):

- global permutation seeded by ``(seed, epoch)`` — every rank computes the
  same permutation with no communication
- pad by wrapping from the start so length divides evenly, then strided
  assignment ``indices[rank::world]``
- ``shuffle=False`` mode for validation (sequential, still padded+sharded)

Deltas from torch's sampler:

- also emits a 0/1 *validity* mask per index so padded duplicates can be
  masked out of loss and metrics, making sharded eval exact;
- the permutation uses numpy's seeded Generator (host-side), so batches
  keep static shapes.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class DistributedShardSampler:
    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for world {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch (reference distributed.py:202-203)."""
        self.epoch = epoch

    def state_dict(self) -> dict:
        """The iterator RNG state a step-granular checkpoint records:
        ``(seed, epoch)`` fully determines the global permutation (computed
        identically on every rank with no communication), so restoring
        these two integers + a step offset reproduces the exact remaining
        index stream — no index lists on disk."""
        return {"seed": int(self.seed), "epoch": int(self.epoch)}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``(seed, epoch)`` from a checkpoint's ft record."""
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])

    def global_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, valid) after shuffle+pad, before rank sharding."""
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        valid = np.ones(self.dataset_len, dtype=np.int32)
        if self.drop_last:
            idx = idx[: self.total_size]
            valid = valid[: self.total_size]
        elif self.total_size > self.dataset_len:
            pad = self.total_size - self.dataset_len
            # Wrap-pad like DistributedSampler: repeat from the front.
            reps = -(-pad // self.dataset_len)
            extra = np.tile(idx, reps)[:pad]
            idx = np.concatenate([idx, extra])
            valid = np.concatenate([valid, np.zeros(pad, dtype=np.int32)])
        return idx, valid

    def shard(self) -> Tuple[np.ndarray, np.ndarray]:
        """This rank's (indices, valid), strided like DistributedSampler."""
        idx, valid = self.global_indices()
        return idx[self.rank :: self.num_replicas], valid[self.rank :: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.shard()[0].tolist())

    def __len__(self) -> int:
        return self.num_samples
