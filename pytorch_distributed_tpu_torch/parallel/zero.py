"""ZeRO-style weight-update sharding (WUS) over the data-parallel group, the
port of ``pytorch_distributed_tpu/parallel/zero.py``.

Automatic cross-replica weight-update sharding (arXiv:2004.13336) removes
the replicated optimizer state of plain data parallelism without touching
the forward and backward: instead of all-reducing the gradients and
applying the same SGD update on every rank,

- **reduce-scatter** the gradients, so rank ``i`` owns the exact f32 sum of
  chunk ``i`` (1/N of every leaf, ``qcomm.chunk_layout``'s whole blocks);
- keep the momentum buffer **sharded**: each rank stores its chunk only;
- apply the reference SGD (``g += wd * p; buf = mu * buf + g``) on it;
- **all-gather** the result once a step and apply it on every rank.

Both wire hops compose with ``--grad-compress int8|fp8`` (the quantized
reduce-scatter and all-gather of ``ops/qcomm.py``, with error feedback on
each).  The JAX package carries the momentum stacked ``(n, chunk)`` and
sharded over the data axis; here each rank holds its own row.  Checkpoints
store the param-shaped momentum either way (``gather_momentum`` /
``shard_momentum``), so runs with and without ``wus`` restore each other.

These functions take JAX-layout trees (``utils/convert.py::jax_leaves``)
and a ``torch.distributed`` group (None: one rank, the same arithmetic).
They and the train step (``train/gradsync.py``) run the same stages on the
same packed buffers (``qcomm.PackedLayout``: ``scatter_start``,
``gather_flat``, ``gather_row``, ``own_row``, :func:`sgd_chunk`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.qcomm import tree_leaves, tree_unflatten

MODES = ("none", "wus")


def resolve_zero(zero: Optional[str]) -> str:
    """Canonical zero mode from the CLI/config value (None -> ``"none"``)."""
    mode = zero if zero is not None else "none"
    if mode not in MODES:
        raise ValueError(f"zero must be one of {MODES}, got {mode!r}")
    return mode


def chunk_size(size: int, n: int, block: int = qcomm.DEFAULT_BLOCK) -> int:
    """Per-rank flat chunk length of a ``size``-element leaf."""
    total, _ = qcomm.chunk_layout(size, n, block)
    return total // n


def gather_momentum(momentum, params):
    """Stacked-chunk ``momentum["buf"]`` -> the param-shaped host tree (what
    every checkpoint stores); ``agerr`` is dropped: it restarts at zero."""
    def g(b, p):
        shape = np.shape(p)
        size = int(np.prod(shape, dtype=np.int64))
        return np.asarray(b, np.float32).reshape(-1)[:size].reshape(shape)

    return tree_unflatten(params, [g(b, p) for b, p in zip(tree_leaves(momentum["buf"]),
                                                           tree_leaves(params))])


def shard_momentum(host_momentum, template_buf):
    """Param-shaped momentum -> stacked chunks shaped as ``template_buf``'s
    (the inverse of :func:`gather_momentum`; the padding is zero)."""
    def s(m, t):
        n, chunk = np.shape(t)
        flat = np.zeros(n * chunk, np.float32)
        arr = np.asarray(m, np.float32).reshape(-1)
        flat[: arr.size] = arr
        return flat.reshape(n, chunk)

    return tree_unflatten(template_buf, [s(m, t) for m, t in zip(tree_leaves(host_momentum),
                                                                 tree_leaves(template_buf))])


# ------------------------------------------------------------- per rank

def reduce_scatter_grads(grads, group, n: int, cast_dtype=None,
                         block: int = qcomm.DEFAULT_BLOCK):
    """f32 (or ``cast_dtype``-wire) reduce-scatter: each leaf's flat chunk of
    this rank, the exact sum over the ranks (padding rides as zeros)."""
    g_leaves = [qcomm._t(g) for g in tree_leaves(grads)]
    lay = qcomm.PackedLayout([g.numel() for g in g_leaves], n, block)
    row = qcomm.scatter_finish(qcomm.scatter_start(lay, lay.pack(g_leaves), group, cast_dtype))
    return tree_unflatten(grads, [c.clone() for c in lay.row_split(row)])


def sgd_chunk(g: torch.Tensor, p: torch.Tensor, buf: torch.Tensor, momentum_coef: float,
              weight_decay: float) -> torch.Tensor:
    """The reference SGD's buffer update on a chunk, in place, with the very
    operations ``torch.optim.SGD`` applies to whole tensors (elementwise, so
    a chunk's numbers are the whole tensor's): ``g + wd * p`` as
    ``g.add(p, alpha=wd)``, then ``buf * mu + g``; returns ``buf``."""
    d = g.add(p, alpha=weight_decay)
    return buf.mul_(momentum_coef).add_(d)


def wus_update_chunks(params, momentum, grad_chunks, lr, idx: int, n: int,
                      momentum_coef: float = 0.9, weight_decay: float = 1e-4,
                      block: int = qcomm.DEFAULT_BLOCK):
    """The compute half of the WUS step on this rank's flat chunks (no
    collective): ``(delta_tree, new_buf_tree)``, ``delta = lr * buf``."""
    p_leaves = [qcomm._t(p) for p in tree_leaves(params)]
    b_leaves = [qcomm._t(b) for b in tree_leaves(momentum["buf"])]
    g_leaves = [qcomm._t(g) for g in tree_leaves(grad_chunks)]
    if not (len(p_leaves) == len(b_leaves) == len(g_leaves)):
        raise ValueError("wus_update_chunks: params / momentum['buf'] / "
                         "grad chunk trees do not match")
    lay = qcomm.PackedLayout([p.numel() for p in p_leaves], n, block)
    buf = sgd_chunk(lay.row_join(g_leaves), lay.own_row(p_leaves, idx), lay.row_join(b_leaves),
                    momentum_coef, weight_decay)
    deltas = [d.clone() for d in lay.row_split(buf * lr)]
    new_buf = [c.reshape(b.shape).clone() for c, b in zip(lay.row_split(buf), b_leaves)]
    return tree_unflatten(params, deltas), tree_unflatten(params, new_buf)


def wus_gather_deltas(delta_tree, agerr, params, group, mode: str = "none", cast_dtype=None,
                      block: int = qcomm.DEFAULT_BLOCK, bucket_mb: Optional[float] = None):
    """The wire half of the WUS step: this rank's delta chunks all-gathered
    to full leaves (f32, a ``cast_dtype`` wire, or the quantized path with
    error feedback in ``agerr``).  ``bucket_mb`` gathers in buckets (forward
    order); per leaf the result is the same.  ``(full_delta_tree,
    new_agerr_or_None)``."""
    from pytorch_distributed_tpu_torch.parallel import overlap as overlap_lib

    d_leaves = [qcomm._t(d) for d in tree_leaves(delta_tree)]
    p_leaves = [qcomm._t(p) for p in tree_leaves(params)]
    use_ef = agerr is not None and len(tree_leaves(agerr)) > 0
    e_leaves = tree_leaves(agerr) if use_ef else [None] * len(d_leaves)
    n, _ = qcomm.group_size(group)
    buckets = ([list(range(len(d_leaves)))] if bucket_mb is None else
               list(reversed(overlap_lib.plan_buckets(p_leaves, bucket_mb))))
    full, e_out = [None] * len(d_leaves), [None] * len(d_leaves)
    for bucket in buckets:
        lay = qcomm.PackedLayout([p_leaves[i].numel() for i in bucket], n, block)
        row = lay.row_join([d_leaves[i].float() for i in bucket])
        if mode in qcomm.QUANTIZED_MODES:
            e_row = lay.row_join([qcomm._t(e_leaves[i]) for i in bucket]) if use_ef else None
            flat, new_e = qcomm.gather_row(lay, row, group, mode, e_row)
        else:
            flat, new_e = qcomm.gather_flat(lay, row, group, cast_dtype), None
        shaped = lay.unpack(flat, [p_leaves[i].shape for i in bucket])
        chunks = lay.row_split(new_e) if new_e is not None else [None] * len(bucket)
        for i, v, e in zip(bucket, shaped, chunks):
            full[i] = v.clone()
            if e is not None:
                e_out[i] = e.reshape(qcomm._t(e_leaves[i]).shape).clone()
    return (tree_unflatten(delta_tree, full),
            tree_unflatten(agerr, e_out) if use_ef else agerr)


def wus_apply_updates(params, momentum, grad_chunks, lr, idx: int, n: int, group,
                      momentum_coef: float = 0.9, weight_decay: float = 1e-4,
                      mode: str = "none", cast_dtype=None, block: int = qcomm.DEFAULT_BLOCK,
                      bucket_mb: Optional[float] = None):
    """:func:`wus_update_chunks` then :func:`wus_gather_deltas`, the
    gathered delta subtracted from the replicated params on every rank:
    ``(new_params, new_momentum)``."""
    agerr = momentum.get("agerr")
    delta_tree, new_buf = wus_update_chunks(params, momentum, grad_chunks, lr, idx, n,
                                            momentum_coef=momentum_coef,
                                            weight_decay=weight_decay, block=block)
    new_momentum = {"buf": new_buf}
    full, new_agerr = wus_gather_deltas(delta_tree, agerr, params, group, mode=mode,
                                        cast_dtype=cast_dtype, block=block, bucket_mb=bucket_mb)
    if new_agerr is not None:
        new_momentum["agerr"] = new_agerr
    new_params = tree_unflatten(params, [(qcomm._t(p).float() - d).to(qcomm._t(p).dtype)
                                         for p, d in zip(tree_leaves(params),
                                                         tree_leaves(full))])
    return new_params, new_momentum


def chunk_sq_sum(tree) -> torch.Tensor:
    """Sum of squares over a chunk tree: one rank's part of the global
    gradient norm (the chunks are disjoint, so the ranks' parts add up)."""
    return sum(qcomm._t(leaf).float().square().sum() for leaf in tree_leaves(tree))
