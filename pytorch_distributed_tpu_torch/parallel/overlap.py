"""Comm-overlap scheduler: bucketed gradient sync, the port of
``pytorch_distributed_tpu/parallel/overlap.py``.

The reference's Horovod recipe hides the gradient all-reduce behind the
backward pass with fusion buffers and hooks that fire as soon as a bucket's
gradients are ready.  This is the same schedule over the JAX package's
buckets:

- the gradient leaves, in the JAX flatten order (``utils/convert.py::
  jax_leaves``), are partitioned into ~``bucket_mb``-MiB buckets in
  **reverse** order (close to the order the backward produces them); a
  leaf is never split;
- the train step (``train/steps.py``) issues each bucket's collective
  (``all_reduce``, the quantized all-reduce or the reduce-scatter) with
  ``async_op=True`` from ``register_post_accumulate_grad_hook`` as soon as
  the bucket's last gradient is ready, on the last microbatch only, and
  waits for them all before dividing by the weight count;
- the math per leaf is the monolithic sync's, so bucketed equals
  ``--overlap none`` bit for bit at 1 and 2 ranks, where a sum of two
  addends has one order (NCCL at more ranks may sum a bucket in another
  order than the whole).

The ZeRO analogue: the bucketed reduce-scatter here and the delta
all-gather in buckets (``zero.wus_gather_deltas(bucket_mb=...)``), and the
**deferred** gather (``wus_gather="deferred"``), which stages a step's
delta chunks as ``pending`` and applies them at the head of the next step
(:func:`drain_pending`), so parameters lag one delta until the train
step's ``GradSync.materialize`` drains it before an eval or a checkpoint.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.qcomm import tree_leaves, tree_unflatten
from pytorch_distributed_tpu_torch.parallel import zero as zero_lib

MODES = ("none", "bucketed")
DEFAULT_BUCKET_MB = 4.0
_MIB = float(1 << 20)


def resolve_overlap(overlap: Optional[str]) -> str:
    """Canonical overlap mode from the CLI/config value (None -> "none")."""
    mode = overlap if overlap is not None else "none"
    if mode not in MODES:
        raise ValueError(f"overlap must be one of {MODES}, got {mode!r}")
    return mode


def _leaf_bytes(leaf) -> int:
    shape = tuple(np.shape(leaf)) if not isinstance(leaf, torch.Tensor) else tuple(leaf.shape)
    size = int(math.prod(shape)) if shape else 1
    dtype = leaf.dtype
    item = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
    return size * item


def plan_buckets(tree, bucket_mb: float = DEFAULT_BUCKET_MB) -> List[List[int]]:
    """Partition a tree's flat leaves into reverse-order byte buckets: leaf
    index lists covering every leaf once.  Bucket 0 holds the last leaves of
    the flatten order; a bucket closes once it holds ``bucket_mb`` MiB (a
    single larger leaf gets its own bucket)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return []
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    budget = bucket_mb * _MIB
    buckets: List[List[int]] = []
    cur: List[int] = []
    acc = 0.0
    for i in reversed(range(len(leaves))):
        cur.append(i)
        acc += _leaf_bytes(leaves[i])
        if acc >= budget:
            buckets.append(cur)
            cur, acc = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_psum(grads, residual, group, *, mode: str = "none", cast_dtype=None,
                  bucket_mb: float = DEFAULT_BUCKET_MB, block: int = qcomm.DEFAULT_BLOCK):
    """Bucketed gradient all-reduce: per bucket, ``qcomm.compressed_psum``
    (quantized modes, the residual threaded through) or a ``cast_dtype``
    wire and a sum.  Leaves come back f32 (quantized) or in the wire's
    dtype, as the JAX function's."""
    g_leaves = [qcomm._t(g) for g in tree_leaves(grads)]
    buckets = plan_buckets(g_leaves, bucket_mb)
    use_ef = mode in qcomm.QUANTIZED_MODES and len(tree_leaves(residual)) > 0
    r_leaves = tree_leaves(residual) if use_ef else [None] * len(g_leaves)
    if use_ef and len(r_leaves) != len(g_leaves):
        raise ValueError("residual tree does not match the gradient tree")
    out_g: List[Any] = [None] * len(g_leaves)
    out_r: List[Any] = [None] * len(g_leaves)
    for bucket in buckets:
        gs = [g_leaves[i] for i in bucket]
        if mode in qcomm.QUANTIZED_MODES:
            synced, new_rs = qcomm.compressed_psum(
                gs, [r_leaves[i] for i in bucket] if use_ef else {}, group, mode=mode,
                block=block)
            rs = new_rs if use_ef else [None] * len(bucket)
        else:
            synced = qcomm.sum_finish(qcomm.sum_start(gs, group, cast_dtype),
                                      [tuple(g.shape) for g in gs])
            rs = [None] * len(bucket)
        for i, s, r in zip(bucket, synced, rs):
            out_g[i], out_r[i] = s, r
    return (tree_unflatten(grads, out_g),
            tree_unflatten(residual, out_r) if use_ef else residual)


def bucketed_reduce_scatter(grads, residual, group, n: int, *, mode: str = "none",
                            cast_dtype=None, bucket_mb: float = DEFAULT_BUCKET_MB,
                            block: int = qcomm.DEFAULT_BLOCK):
    """Bucketed reduce-scatter for the ZeRO path: per bucket,
    ``zero.reduce_scatter_grads`` or ``qcomm.compressed_reduce_scatter``;
    flat ``(chunk,)`` leaves as the monolithic helpers give."""
    g_leaves = [qcomm._t(g) for g in tree_leaves(grads)]
    buckets = plan_buckets(g_leaves, bucket_mb)
    use_ef = mode in qcomm.QUANTIZED_MODES and len(tree_leaves(residual)) > 0
    r_leaves = tree_leaves(residual) if use_ef else [None] * len(g_leaves)
    out_g: List[Any] = [None] * len(g_leaves)
    out_r: List[Any] = [None] * len(g_leaves)
    for bucket in buckets:
        gs = [g_leaves[i] for i in bucket]
        if mode in qcomm.QUANTIZED_MODES:
            chunks, new_rs = qcomm.compressed_reduce_scatter(
                gs, [r_leaves[i] for i in bucket] if use_ef else {}, group, mode=mode,
                block=block)
            rs = new_rs if use_ef else [None] * len(bucket)
        else:
            chunks = zero_lib.reduce_scatter_grads(gs, group, n, cast_dtype=cast_dtype,
                                                   block=block)
            rs = [None] * len(bucket)
        for i, c, r in zip(bucket, chunks, rs):
            out_g[i], out_r[i] = c, r
    return (tree_unflatten(grads, out_g),
            tree_unflatten(residual, out_r) if use_ef else residual)


# ------------------------------------------- deferred WUS gather (2-buffer)

def drain_pending(params, pending, group, *, cast_dtype=None):
    """All-gather this rank's staged delta chunks (``(1, chunk)`` per leaf)
    and subtract them from the params: the head of a deferred step."""
    p_leaves = tree_leaves(params)
    full, _ = zero_lib.wus_gather_deltas(
        [qcomm._t(d).reshape(-1) for d in tree_leaves(pending)], None, p_leaves, group,
        cast_dtype=cast_dtype)
    return tree_unflatten(params, [(qcomm._t(p).float() - d).to(qcomm._t(p).dtype)
                                   for p, d in zip(p_leaves, full)])
