"""Paged KV cache: a fixed-size block pool + per-sequence block tables.

Port of ``pytorch_distributed_tpu/serving/kvpool.py``.  vLLM-style paged
attention (arXiv 2309.06180) at static shapes: the device holds one KV pool
per side, ``[n_layers, n_blocks, block_size, n_heads, head_dim]``, and every
sequence owns an ordered list of physical blocks recorded in a
``[B_max, blocks_per_seq]`` block table.  The serving steps
(serving/engine.py) scatter new k/v through the table and gather each
slot's logical window back out — both at static shapes, so the decode
step is captured once as a CUDA graph no matter how sequences churn.

Split of responsibilities:

- ``BlockPool`` is pure host state (numpy, a verbatim copy of the JAX
  package's): the free list, per-sequence block lists, alloc/free/defrag,
  and the occupancy/fragmentation counters the SLO metrics report.
- The module-level device helpers (``init_pools``, ``lookup_blocks``,
  ``paged_scatter``, ``paged_gather``, ``apply_permutation``) are torch
  functions.  Where the JAX ones return new pools, these write **in
  place**: the decode graph holds the pools' addresses, so a pool is
  never rebound.

Physical block 0 is reserved as the null/garbage sink: the allocator
never hands it out, unset table entries are 0, and every out-of-window
or inactive-slot write routes there.  Reads never see it unmasked — a
slot only attends to logical positions below its committed offset, and
those always map to really-allocated blocks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


class BlockPool:
    """Host-side allocator over ``n_blocks`` fixed-size KV blocks.

    Block 0 is reserved (the null sink), so usable capacity is
    ``n_blocks - 1`` blocks of ``block_size`` tokens each.  Sequences
    grow monotonically via ``ensure`` and release everything at once via
    ``free`` (preempt-and-requeue restarts from scratch — recompute, not
    swap).  ``defrag`` compacts used blocks to the low end of the pool
    and returns the gather permutation the engine applies on device.
    """

    def __init__(self, n_blocks: int, block_size: int, blocks_per_seq: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2 (block 0 is reserved), "
                             f"got {n_blocks}")
        if block_size < 1 or blocks_per_seq < 1:
            raise ValueError("block_size and blocks_per_seq must be >= 1")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.blocks_per_seq = int(blocks_per_seq)
        # LIFO free stack: low block ids come back first, which is what
        # makes fragmentation (and defrag) observable after churn.
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._seqs: Dict[Any, List[int]] = {}
        self.alloc_failures = 0
        self.defrags = 0

    # ------------------------------------------------------------- capacity
    @property
    def capacity_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def capacity_tokens(self) -> int:
        """Max tokens a single sequence can commit (its table width)."""
        return self.blocks_per_seq * self.block_size

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity_blocks - len(self._free)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def can_alloc(self, n_blocks: int) -> bool:
        return len(self._free) >= n_blocks

    def occupancy_pct(self) -> float:
        return 100.0 * self.used_blocks / self.capacity_blocks

    def fragmentation_pct(self) -> float:
        """Spread of the used region past its compact size: with U used
        blocks spanning up to id S, ``100 * (S - U) / S``.  0 when the
        used blocks sit contiguously at the low end (or nothing is
        used); defrag drives it back to 0."""
        used = [b for blocks in self._seqs.values() for b in blocks]
        if not used:
            return 0.0
        span = max(used)
        return 100.0 * (span - len(used)) / span

    # ----------------------------------------------------------- alloc/free
    def blocks_of(self, sid: Any) -> List[int]:
        return list(self._seqs.get(sid, ()))

    def ensure(self, sid: Any, n_tokens: int) -> bool:
        """Grow ``sid``'s allocation to cover ``n_tokens`` committed
        positions.  Returns False (books an alloc failure, changes
        nothing) when the pool is exhausted — the scheduler's cue to
        preempt."""
        if n_tokens > self.capacity_tokens:
            raise ValueError(
                f"sequence needs {n_tokens} tokens > table capacity "
                f"{self.capacity_tokens} ({self.blocks_per_seq} blocks × "
                f"{self.block_size}); admission should have clamped it")
        have = len(self._seqs.get(sid, ()))
        need = self.blocks_needed(n_tokens) - have
        if need <= 0:
            return True
        if len(self._free) < need:
            self.alloc_failures += 1
            return False
        blocks = self._seqs.setdefault(sid, [])
        for _ in range(need):
            blocks.append(self._free.pop())
        return True

    def free(self, sid: Any) -> int:
        """Release every block ``sid`` holds; returns how many."""
        blocks = self._seqs.pop(sid, [])
        self._free.extend(blocks)
        return len(blocks)

    # ----------------------------------------------------------- block table
    def table(self, sids: Sequence[Optional[Any]]) -> np.ndarray:
        """The ``[len(sids), blocks_per_seq]`` int32 block table for the
        given slot->sequence assignment (None = empty slot, all-zero row
        -> every access routes to the null block)."""
        out = np.zeros((len(sids), self.blocks_per_seq), np.int32)
        for row, sid in enumerate(sids):
            if sid is None:
                continue
            for j, b in enumerate(self._seqs.get(sid, ())):
                out[row, j] = b
        return out

    # --------------------------------------------------------------- defrag
    def defrag(self) -> np.ndarray:
        """Compact used blocks to ids ``1..used`` (sequence order
        preserved) and return the length-``n_blocks`` permutation to
        apply on device: ``new_pool = old_pool[perm]``.  Identity when
        already compact."""
        perm = np.arange(self.n_blocks, dtype=np.int32)
        new_id = 1
        moved = False
        used_old = set()
        for blocks in self._seqs.values():
            for j, old in enumerate(blocks):
                if old != new_id:
                    moved = True
                perm[new_id] = old
                blocks[j] = new_id
                used_old.add(old)
                new_id += 1
        if not moved:
            return perm
        spare = [b for b in range(1, self.n_blocks) if b not in used_old]
        for j, old in enumerate(spare):
            perm[new_id + j] = old
        # free list over the compacted tail, low ids popped first
        self._free = list(range(self.n_blocks - 1, new_id - 1, -1))
        self.defrags += 1
        return perm


# ------------------------------------------------------- device-side helpers

def init_pools(n_layers: int, n_blocks: int, block_size: int, n_heads: int,
               head_dim: int, dtype: torch.dtype = torch.float32,
               device="cuda"):
    """Zeroed ``(pool_k, pool_v)``, each
    ``[n_layers, n_blocks, block_size, n_heads, head_dim]``.  Zero init
    matters for exactness: masked attention weights are exactly 0.0, and
    0.0 × finite is 0.0 — never-NaN garbage reads."""
    shape = (n_layers, n_blocks, block_size, n_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def lookup_blocks(table: torch.Tensor, pos: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """Physical block id for each logical position: ``table [B, W]``,
    ``pos [B, L]`` (int64) -> ``[B, L]``.  Positions past the table window
    route to the null block 0 (out-of-range writes land in garbage, never
    in a live block)."""
    idx = pos // block_size
    w = table.shape[1]
    blk = torch.gather(table, 1, idx.clamp(0, w - 1))
    return torch.where(idx < w, blk, torch.zeros_like(blk))


def paged_scatter(pool_l: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """Write ``val [B, L, H, D]`` at ``(blk, off) [B, L]`` into one layer's
    pool ``[NB, BS, H, D]``, in place; returns the pool.  Distinct live
    slots never collide (the allocator hands each sequence disjoint
    blocks); only null-block writes can duplicate, and block 0 is garbage
    by contract (whichever duplicate lands, it is finite)."""
    return pool_l.index_put_((blk, off), val.to(pool_l.dtype))


def paged_gather(pool_l: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather a slot-major logical KV window: ``[B, W] -> [B, W*BS, H, D]``
    — the static-shape keys/values tensor paged attention masks against."""
    g = pool_l[table]                      # [B, W, BS, H, D]
    b, w, bs, h, d = g.shape
    return g.reshape(b, w * bs, h, d)


def apply_permutation(pool: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Relocate blocks after a host-side ``BlockPool.defrag()``, in place:
    ``pool[:] = pool[:, perm]`` (one gather into a temporary, copied back
    into the same storage).  Returns the pool."""
    return pool.copy_(pool[:, perm])
