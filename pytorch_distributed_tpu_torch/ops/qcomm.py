"""Quantized gradient collectives, the port of ``pytorch_distributed_tpu/ops/qcomm.py``:
int8/fp8 wire compression for data parallelism.

The reference's Horovod recipe compresses gradients to fp16 on the wire
(horovod_distributed.py:159-164); the explicit step matches it with a bf16
cast.  This module goes further, as the JAX package does:

- **EQuARX** (arXiv:2506.17615): a quantized all-reduce decomposed as
  quantize -> all-to-all of the int8 (or fp8) blocks and their f32 scales
  -> dequantize and accumulate in f32 -> re-quantize -> all-gather, so the
  wire carries ~1 byte an element on both hops while every accumulation
  stays f32 (an int8 reduce-scatter would overflow).
- **DynamiQ** (arXiv:2602.08923): error feedback.  Each rank keeps what its
  quantizer dropped and adds it to the next step's gradient, so the error
  telescopes instead of accumulating.

Quantization is per-block symmetric: blocks of ``DEFAULT_BLOCK`` elements
share one f32 scale from their absolute maximum, the payload is int8 or
``torch.float8_e4m3fn``.  The arithmetic is the JAX package's to the bit as
XLA compiles it inside the JAX steps: ``inv = where(absmax > 0, qmax /
absmax, 0)`` then ``x * inv`` (never ``x / scale``), clipped before the
cast, ``torch.round`` half to even as ``jnp.round``; the scale ``absmax /
qmax`` becomes ``absmax * f32(1 / qmax)`` there.  A residual ``x - q *
scale`` is the exact quantization error rounded once; XLA fuses the
multiply into the subtraction for some residuals and not for others (it
depends on the payload type and the program), so JAX's may differ from it
by the rounding of that one product.
Every constant is a tensor on the data's device (on CUDA, a tensor divided
by a Python number is multiplied by its reciprocal, which ``qmax / absmax``
must not be).

Trees are the JAX ``params`` trees: nested dicts flattened with their keys
sorted (``utils/convert.py::jax_leaves`` gives a model's parameters in that
order and layout), or plain lists of leaves.  The collectives run over a
``torch.distributed`` group; with no group, or at a world of 1, they run
the same arithmetic locally (the JAX step on a one-device mesh still
quantizes twice).  fp8 payloads travel as ``uint8`` views (gloo has no
fp8).  The leaves of one call are packed into one buffer (``PackedLayout``:
each leaf keeps its own ``chunk_layout`` blocks), so a call makes one
all-to-all and one all-gather of the payload and of the scales whatever its
number of leaves.

Error-feedback state: the explicit path's residuals are per rank, one slot
``(1, *shape)`` per leaf on each rank (the JAX package stacks the ranks'
slots ``(n, *shape)`` and shards them; a checkpoint stores that stack).  The
emulation (GSPMD twin, LM step) quantizes the already-synced gradient, so
its residual is replicated and param-shaped.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MODES = ("none", "bf16", "int8", "fp8")
QUANTIZED_MODES = ("int8", "fp8")
DEFAULT_BLOCK = 256

# Largest finite magnitudes of the wire formats (int8 symmetric: -127..127,
# keeping -128 unused so the range is sign-symmetric; e4m3fn: 448).
_QMAX = {"int8": 127.0, "fp8": 448.0}

_FP8 = getattr(torch, "float8_e4m3fn", None)


def fp8_supported() -> bool:
    """True when this torch build has the float8_e4m3fn dtype."""
    return _FP8 is not None


def resolve_mode(grad_compress: Optional[str], wire_dtype=None
                 ) -> Tuple[str, Optional[torch.dtype]]:
    """Canonical ``(mode, cast_dtype)`` from the flag and the legacy knob, as
    in JAX: ``wire_dtype=torch.bfloat16`` maps to mode ``"bf16"``;
    ``cast_dtype`` is set for the cast modes only; conflicting settings
    raise."""
    mode = grad_compress if grad_compress is not None else "none"
    if mode not in MODES:
        raise ValueError(f"grad_compress must be one of {MODES}, got {mode!r}")
    cast_dtype = None
    if wire_dtype is not None:
        if mode == "none":
            warnings.warn(
                "wire_dtype is deprecated; use grad_compress='bf16' "
                "(the wire_dtype=jnp.bfloat16 equivalent)",
                DeprecationWarning, stacklevel=3,
            )
            mode = "bf16"
            cast_dtype = wire_dtype
        elif mode == "bf16":
            cast_dtype = wire_dtype
        else:
            raise ValueError(
                f"wire_dtype={wire_dtype} conflicts with "
                f"grad_compress={mode!r}; drop the deprecated wire_dtype")
    if mode == "bf16" and cast_dtype is None:
        cast_dtype = torch.bfloat16
    if mode == "fp8" and not fp8_supported():
        raise ValueError(
            "grad_compress='fp8' requires a jax build with "
            "jnp.float8_e4m3fn; use 'int8' on this install")
    return mode, cast_dtype


# ------------------------------------------------------------------ trees

def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict / list / tuple, dict keys sorted (the
    ``jax.tree_util`` order); anything else is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: Sequence[Any]):
    """``leaves`` put back into the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


# ----------------------------------------------------------- quantize core

def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _quantize(xb: torch.Tensor, mode: str):
    """Per-block symmetric quantization along the last axis.

    ``xb``: f32 ``(..., block)``.  Returns ``(q, scale)``: ``q`` int8 or
    fp8-e4m3 of ``xb.shape``, ``scale`` f32 of ``xb.shape[:-1]``.  All-zero
    blocks get scale 0 (they dequantize to exact zeros)."""
    qmax = _const(xb, _QMAX[mode])
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # XLA compiles ``absmax / qmax`` as a product with the f32 reciprocal.
    scale = absmax * _const(xb, float(np.float32(1.0) / np.float32(_QMAX[mode])))
    inv = torch.where(absmax > 0, qmax / absmax, torch.zeros((), device=xb.device))
    y = torch.clamp(xb * inv, -_QMAX[mode], _QMAX[mode])
    if mode == "int8":
        q = torch.round(y).to(torch.int8)
    else:
        if _FP8 is None:  # guarded by resolve_mode
            raise ValueError("fp8 dtype unsupported by this torch build")
        q = y.to(_FP8)
    return q, scale.squeeze(-1)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == _FP8 else t


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _error(x: torch.Tensor, deq64: torch.Tensor) -> torch.Tensor:
    """``x - q * scale`` rounded once, given the exact product ``deq64``
    (f64: an int8 or fp8 value times an f32 scale is exact there).  The f64
    difference is exact too (either the product is 0, or it lies within
    half a quantum of ``x``)."""
    return (x.double() - deq64).float()


def quantize_blockwise(x, mode: str = "int8", block: int = DEFAULT_BLOCK):
    """Flatten, zero-pad to a block multiple, quantize per block: ``(q
    (n_blocks, block), scale (n_blocks,))``."""
    flat = _t(x).float().reshape(-1)
    pad = (-flat.numel()) % block
    xb = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    return _quantize(xb, mode)


def dequantize_blockwise(q, scale, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (drops the zero padding)."""
    flat = _dequantize(q, scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def fake_quantize(x, mode: str = "int8", block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Quantize-dequantize round trip: the wire format's numerics without a
    collective (the emulation's primitive)."""
    x = _t(x)
    q, s = quantize_blockwise(x, mode, block)
    return dequantize_blockwise(q, s, tuple(x.shape))


# -------------------------------------------------------- error feedback

def init_residual(params, mode: str, explicit: bool = False, n_data: int = 1):
    """Zero error-feedback residuals for ``mode`` (``{}`` when the mode
    carries no quantization error): ``(n_data, *shape)`` stacked slots for
    the explicit path, param-shaped for the emulation."""
    if mode not in QUANTIZED_MODES:
        return {}
    lead = (n_data,) if explicit else ()
    return tree_unflatten(params, [torch.zeros(lead + tuple(_t(p).shape), dtype=torch.float32,
                                               device=_t(p).device)
                                   for p in tree_leaves(params)])


def compress_emulated(grads, residual, mode: str, block: int = DEFAULT_BLOCK):
    """Quantization numerics and error feedback on an already-synced
    (replicated) gradient: ``(fake_quantize(g + r), (g + r) - that)``.  Does
    not move fewer bytes (the GSPMD twin's and the LM step's emulation,
    which run :func:`emulate` on the same one-rank packed buffer)."""
    g_leaves = [_t(g) for g in tree_leaves(grads)]
    r_leaves = tree_leaves(residual)
    lay = _layout_of(g_leaves, 1, block)
    shapes = [tuple(g.shape) for g in g_leaves]
    res = lay.pack([_t(r) for r in r_leaves]) if r_leaves else None
    out, new_res = emulate(lay, lay.pack([g.float() for g in g_leaves]), res, mode)
    out = tree_unflatten(grads, [t.clone() for t in lay.unpack(out, shapes)])
    if not r_leaves:
        return out, residual
    return out, tree_unflatten(residual, [t.clone() for t in lay.unpack(new_res, shapes)])


# ---------------------------------------------- compressed all-reduce (EQuARX)

def chunk_layout(size: int, n: int, block: int = DEFAULT_BLOCK) -> Tuple[int, int]:
    """``(padded_total, blocks_per_chunk)`` of a ``size``-element leaf split
    into ``n`` per-rank chunks of whole blocks.  Small leaves shrink the
    block instead of ballooning the padding (a 10-element bias on 4 ranks
    pads to 12 elements, not 1024)."""
    chunk = -(-size // n)
    blk = min(block, chunk)
    chunk = -(-chunk // blk) * blk
    return n * chunk, chunk // blk


class PackedLayout:
    """Leaves of ``sizes`` elements for ``n`` ranks in one flat buffer.

    Leaf-major: each leaf's zero-padded flat (``chunk_layout``'s ``n *
    chunk`` elements) is one piece, the leaves ordered by block size
    (largest first, then as given) so the blocks of one size form one
    ``(rows, blk)`` matrix and quantize in one go.  Rank-major: row ``j``
    holds chunk ``j`` of every leaf in the same order (``row`` elements,
    ``row_blocks`` blocks): the layout the all-to-all and the all-gather
    split and the per-rank ZeRO chunks live in.  ``perm`` maps a rank-major
    position to its leaf-major one (``bperm`` the same for blocks)."""

    def __init__(self, sizes: Sequence[int], n: int, block: int = DEFAULT_BLOCK):
        self.sizes, self.n = [int(s) for s in sizes], int(n)
        lay = [chunk_layout(s, n, block) for s in self.sizes]
        self.chunk = [t // n for t, _ in lay]
        self.nb = [nb for _, nb in lay]
        self.blk = [c // nb for c, nb in zip(self.chunk, self.nb)]
        self.order = sorted(range(len(self.sizes)), key=lambda i: -self.blk[i])
        self.off, self.coff, self.cboff = {}, {}, {}
        e = c = b = 0
        self.groups: List[List[int]] = []   # [blk, leaf-major start, end]
        self.row_groups: List[List[int]] = []   # [blk, row start, end]
        for i in self.order:
            self.off[i], self.coff[i], self.cboff[i] = e, c, b
            if self.groups and self.groups[-1][0] == self.blk[i]:
                self.groups[-1][2] += n * self.chunk[i]
                self.row_groups[-1][2] += self.chunk[i]
            else:
                self.groups.append([self.blk[i], e, e + n * self.chunk[i]])
                self.row_groups.append([self.blk[i], c, c + self.chunk[i]])
            e, c, b = e + n * self.chunk[i], c + self.chunk[i], b + self.nb[i]
        self.numel, self.row, self.row_blocks = e, c, b
        self._perms: Dict[Any, Tuple[torch.Tensor, ...]] = {}

    def perms(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(perm, inv_perm, bperm)`` on ``device``, built once."""
        key = str(device)
        if key not in self._perms:
            n, parts, bparts = self.n, [], []
            boff = 0
            for i in self.order:
                parts.append(torch.arange(n * self.chunk[i]).view(n, self.chunk[i]) + self.off[i])
                bparts.append(torch.arange(n * self.nb[i]).view(n, self.nb[i]) + boff)
                boff += n * self.nb[i]
            perm = (torch.cat(parts, 1) if parts else torch.zeros(n, 0, dtype=torch.long)
                    ).reshape(-1)
            bperm = (torch.cat(bparts, 1) if bparts else torch.zeros(n, 0, dtype=torch.long)
                     ).reshape(-1)
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.numel())
            self._perms[key] = tuple(t.to(device) for t in (perm, inv, bperm))
        return self._perms[key]

    def pack(self, leaves: Sequence[Optional[torch.Tensor]], device=None) -> torch.Tensor:
        """The leaves (any shape and strides; None reads as zeros) in one
        zero-padded leaf-major f32 buffer."""
        dev = device if device is not None else next(t.device for t in leaves if t is not None)
        buf = torch.zeros(self.numel, dtype=torch.float32, device=dev)
        for i, t in enumerate(leaves):
            if t is not None:
                buf[self.off[i]:self.off[i] + self.sizes[i]].view(t.shape).copy_(t)
        return buf

    def unpack(self, buf: torch.Tensor, shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
        """Views of a leaf-major buffer as the leaves of ``shapes``."""
        return [buf[self.off[i]:self.off[i] + self.sizes[i]].view(shapes[i])
                for i in range(len(self.sizes))]

    def row_of(self, rank: int, device) -> torch.Tensor:
        """Leaf-major positions of rank ``rank``'s row."""
        return self.perms(device)[0][rank * self.row:(rank + 1) * self.row]

    def own_row(self, leaves: Sequence[Optional[torch.Tensor]], rank: int,
                device=None) -> torch.Tensor:
        """Rank ``rank``'s row of the leaves: chunk ``rank`` of each, f32."""
        x = self.pack(leaves, device)
        return x[self.row_of(rank, x.device)]

    def row_split(self, row: torch.Tensor) -> List[torch.Tensor]:
        """A row's (or ``(..., row)`` rows') chunk of each leaf, as views."""
        return [row[..., self.coff[i]:self.coff[i] + self.chunk[i]]
                for i in range(len(self.sizes))]

    def row_join(self, chunks: Sequence[torch.Tensor]) -> torch.Tensor:
        """One row from each leaf's flat chunk (the inverse of
        :meth:`row_split`)."""
        return torch.cat([chunks[i].reshape(-1) for i in self.order])

    def quantize(self, x: torch.Tensor, mode: str, rows: bool = False):
        """Per-block quantization of a leaf-major buffer (or of one
        rank-major row with ``rows``): ``(q, scales)`` in the same order.
        The payload comes as int8, or fp8 viewed as ``uint8`` (the wire's
        type: indexing and concatenation need no fp8 kernels)."""
        qs, ss = [], []
        for blk, a, b in (self.row_groups if rows else self.groups):
            q, s = _quantize(x[a:b].view(-1, blk), mode)
            qs.append(_wire(q).reshape(-1))
            ss.append(s)
        if not qs:
            return (torch.empty(0, dtype=torch.int8 if mode == "int8" else torch.uint8,
                                device=x.device),
                    torch.empty(0, dtype=torch.float32, device=x.device))
        return torch.cat(qs), torch.cat(ss)

    def dequantize(self, q: torch.Tensor, s: torch.Tensor, rows: bool = False,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Inverse of :meth:`quantize` on matching (leading-dim-batched)
        buffers: ``q`` ``(..., elements)``, ``s`` ``(..., blocks)``
        (``dtype=torch.float64``: the exact products, for :func:`_error`)."""
        if q.dtype == torch.uint8:
            q = q.view(_FP8)
        out, boff = [], 0
        for blk, a, b in (self.row_groups if rows else self.groups):
            nb = (b - a) // blk
            out.append((q[..., a:b].unflatten(-1, (nb, blk)).to(dtype)
                        * s[..., boff:boff + nb, None].to(dtype)).flatten(-2))
            boff += nb
        return torch.cat(out, -1) if out else q.to(dtype)

    def error(self, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              rows: bool = False) -> torch.Tensor:
        """What the quantizer dropped: ``x - dequantize(q, s)``, rounded
        once (:func:`_error`)."""
        return _error(x, self.dequantize(q, s, rows, torch.float64))


# ----------------------------------------------------------- the wire

def group_size(group) -> Tuple[int, int]:
    """``(n, rank)`` of ``group`` (``(1, 0)`` without one)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def all_to_all(t: torch.Tensor, group, async_op: bool = False):
    """Rows of ``t`` (its first dimension split in ``n``) exchanged: row
    ``j`` goes to rank ``j``, row ``j`` of the result came from rank ``j``.
    Without a group (or at world 1) the tensor itself.  ``async_op``:
    ``(out, work)``."""
    if group is None or dist.get_world_size(group) == 1:
        return (t, None) if async_op else t
    out = torch.empty_like(t)
    work = dist.all_to_all_single(_wire(out), _wire(t), group=group, async_op=async_op)
    return (out, work) if async_op else out


def all_gather(t: torch.Tensor, group, async_op: bool = False):
    """``(n, *t.shape)``: every rank's ``t``.  Without a group the tensor
    itself with a leading 1."""
    if group is None or dist.get_world_size(group) == 1:
        out = t.unsqueeze(0)
        return (out, None) if async_op else out
    n = dist.get_world_size(group)
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    work = dist.all_gather_into_tensor(_wire(out), _wire(t.contiguous()), group=group,
                                       async_op=async_op)
    out = out.view((n,) + tuple(t.shape))
    return (out, work) if async_op else out


def reduce_scatter(t: torch.Tensor, group, async_op: bool = False):
    """The sum over the ranks of row ``rank`` of ``t`` (``(n, row)``),
    in ``t``'s dtype."""
    if group is None or dist.get_world_size(group) == 1:
        out = t[0]
        return (out, None) if async_op else out
    out = torch.empty(t[0].numel(), dtype=t.dtype, device=t.device)
    work = dist.reduce_scatter_tensor(out, t.contiguous().view(-1), group=group,
                                      async_op=async_op)
    out = out.view(t.shape[1:])
    return (out, work) if async_op else out


def _wait(*works) -> None:
    for w in works:
        if w is not None:
            w.wait()


# -------------------------------------- the packed stages (one bucket)

def emulate(lay: PackedLayout, x: torch.Tensor, res: Optional[torch.Tensor], mode: str
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The emulation on a one-rank leaf-major buffer: ``x + res`` quantized
    and dequantized, and what the quantizer dropped (None without
    ``res``)."""
    comp = x if res is None else x + res
    q, s = lay.quantize(comp, mode)
    return lay.dequantize(q, s), (None if res is None else lay.error(comp, q, s))


def sum_start(tensors: Sequence[torch.Tensor], group, wire=None) -> dict:
    """Start the plain all-reduce of ``tensors`` through one flat buffer in
    ``wire``'s dtype (theirs when None).  Returns the context
    :func:`sum_finish` takes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if wire is not None:
        flat = flat.to(wire)
    work = None if group is None else dist.all_reduce(flat, group=group, async_op=True)
    return {"flat": flat, "works": (work,)}


def sum_finish(ctx: dict, shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """The summed tensors of ``shapes``, views in the wire's dtype."""
    _wait(*ctx["works"])
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(ctx["flat"][off:off + n].view(shape))
        off += n
    return out


def scatter_start(lay: PackedLayout, x: torch.Tensor, group, wire=None) -> dict:
    """Start the plain reduce-scatter of a leaf-major buffer ``x`` (in
    ``wire``'s dtype): this rank's row of the sum over the ranks."""
    if wire is not None:
        x = x.to(wire)
    row, work = reduce_scatter(x[lay.perms(x.device)[0]].view(lay.n, lay.row), group,
                               async_op=True)
    return {"row": row, "works": (work,)}


def scatter_finish(ctx: dict) -> torch.Tensor:
    """This rank's row of the sum, f32."""
    _wait(*ctx["works"])
    return ctx["row"].float()


def gather_flat(lay: PackedLayout, row: torch.Tensor, group, wire=None) -> torch.Tensor:
    """The plain all-gather of every rank's row (in ``wire``'s dtype): the
    leaf-major f32 buffer."""
    if wire is not None:
        row = row.to(wire)
    full = all_gather(row, group).float().reshape(-1)
    return full[lay.perms(full.device)[1]]


def psum_start(lay: PackedLayout, x: torch.Tensor, res: Optional[torch.Tensor], group,
               mode: str) -> dict:
    """Stage 1 of the compressed all-reduce of a leaf-major buffer ``x``
    (``res``: this rank's leaf-major residual, or None): quantize, send the
    all-to-all.  Returns the context :func:`psum_finish` takes."""
    if res is not None:
        x = x + res
    q1, s1 = lay.quantize(x, mode)
    perm, _, bperm = lay.perms(x.device)
    qt, w1 = all_to_all(q1[perm], group, async_op=True)
    st, w2 = all_to_all(s1[bperm], group, async_op=True)
    return {"x": x, "q1": q1, "s1": s1, "qt": qt, "st": st, "works": (w1, w2)}


def owned_sum(lay: PackedLayout, ctx: dict) -> torch.Tensor:
    """Wait for stage 1 and accumulate this rank's row in f32: the sum over
    the ranks of their dequantized chunks."""
    _wait(*ctx["works"])
    n = lay.n
    deq = lay.dequantize(ctx["qt"].view(n, lay.row), ctx["st"].view(n, lay.row_blocks),
                         rows=True)
    return deq.sum(0)


def stage1_error(lay: PackedLayout, ctx: dict) -> torch.Tensor:
    """What stage 1's quantizer dropped, leaf-major."""
    return lay.error(ctx["x"], ctx["q1"], ctx["s1"])


def psum_finish(lay: PackedLayout, ctx: dict, group, rank: int, mode: str,
                with_residual: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stage 2: this rank's row re-quantized and all-gathered.  Returns the
    leaf-major f32 sum over the ranks and the new residual (the stage-1
    error, with this rank's row also carrying the stage-2 error, so the
    residuals summed over the ranks equal the true sum minus the wire's)."""
    owned = owned_sum(lay, ctx)
    q2, s2 = lay.quantize(owned, mode, rows=True)
    qg, w1 = all_gather(q2, group, async_op=True)
    sg, w2 = all_gather(s2, group, async_op=True)
    res = None
    if with_residual:
        res = stage1_error(lay, ctx)
        e2 = lay.error(owned, q2, s2, rows=True)
        res.index_add_(0, lay.row_of(rank, owned.device), e2)
    _wait(w1, w2)
    summed = lay.dequantize(qg, sg, rows=True).reshape(-1)
    _, inv, _ = lay.perms(summed.device)
    return summed[inv], res


def gather_row(lay: PackedLayout, row: torch.Tensor, group, mode: str,
               err: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantized all-gather of this rank's row (``err``: its error-feedback
    row, or None): the leaf-major f32 result every rank dequantizes alike,
    and the new error row."""
    x = row if err is None else row + err
    q, s = lay.quantize(x, mode, rows=True)
    qg, w1 = all_gather(q, group, async_op=True)
    sg, w2 = all_gather(s, group, async_op=True)
    new_err = None if err is None else lay.error(x, q, s, rows=True)
    _wait(w1, w2)
    full = lay.dequantize(qg, sg, rows=True).reshape(-1)
    return full[lay.perms(full.device)[1]], new_err


# -------------------------------------------------- the JAX functions

def _layout_of(leaves, n: int, block: int) -> PackedLayout:
    return PackedLayout([_t(t).numel() for t in leaves], n, block)


def compressed_psum(grads, residual, group=None, mode: str = "int8",
                    block: int = DEFAULT_BLOCK):
    """Quantized all-reduce of a gradient tree over ``group``: every leaf's
    f32 sum over the ranks, and the new residual tree (this rank's
    ``(1, *shape)`` slots; ``{}`` in, ``{}`` out).

    Wire cost per leaf of L elements at n ranks, against an f32 ring
    all-reduce's ``2(n-1)/n * 4L`` bytes: ``2(n-1)/n * (L + 4L/block)``."""
    if mode not in QUANTIZED_MODES:
        raise ValueError(f"compressed_psum: mode must be one of "
                         f"{QUANTIZED_MODES}, got {mode!r}")
    n, rank = group_size(group)
    g_leaves = [_t(g) for g in tree_leaves(grads)]
    r_leaves = tree_leaves(residual)
    if r_leaves and len(r_leaves) != len(g_leaves):
        raise ValueError("residual tree does not match the gradient tree")
    lay = _layout_of(g_leaves, n, block)
    shapes = [tuple(g.shape) for g in g_leaves]
    x = lay.pack([g.float() for g in g_leaves])
    res = lay.pack([_t(r).reshape(s) for r, s in zip(r_leaves, shapes)]) if r_leaves else None
    summed, new_res = psum_finish(lay, psum_start(lay, x, res, group, mode), group, rank,
                                  mode, bool(r_leaves))
    out = tree_unflatten(grads, [t.clone() for t in lay.unpack(summed, shapes)])
    if not r_leaves:
        return out, residual
    return out, tree_unflatten(residual, [t.reshape((1,) + s).clone()
                                          for t, s in zip(lay.unpack(new_res, shapes), shapes)])


def compressed_reduce_scatter(grads, residual, group=None, mode: str = "int8",
                              block: int = DEFAULT_BLOCK):
    """Quantized reduce-scatter of a gradient tree: each leaf's flat f32
    chunk ``(chunk,)`` of this rank, summed over the ranks from their
    dequantized contributions (the all-to-all hop only), and the stage-1
    residual slots."""
    if mode not in QUANTIZED_MODES:
        raise ValueError(f"compressed_reduce_scatter: mode must be one of "
                         f"{QUANTIZED_MODES}, got {mode!r}")
    n, _ = group_size(group)
    g_leaves = [_t(g) for g in tree_leaves(grads)]
    r_leaves = tree_leaves(residual)
    if r_leaves and len(r_leaves) != len(g_leaves):
        raise ValueError("residual tree does not match the gradient tree")
    lay = _layout_of(g_leaves, n, block)
    shapes = [tuple(g.shape) for g in g_leaves]
    x = lay.pack([g.float() for g in g_leaves])
    res = lay.pack([_t(r).reshape(s) for r, s in zip(r_leaves, shapes)]) if r_leaves else None
    ctx = psum_start(lay, x, res, group, mode)
    chunks = [c.clone() for c in lay.row_split(owned_sum(lay, ctx))]
    if not r_leaves:
        return tree_unflatten(grads, chunks), residual
    e1 = stage1_error(lay, ctx)
    return (tree_unflatten(grads, chunks),
            tree_unflatten(residual, [t.reshape((1,) + s).clone()
                                      for t, s in zip(lay.unpack(e1, shapes), shapes)]))


def compressed_all_gather(chunks, err, group, shaped, mode: str = "int8",
                          block: int = DEFAULT_BLOCK):
    """Quantized all-gather of this rank's flat chunks (``(chunk,)`` per
    leaf, the ZeRO parameter delta) back to full leaves shaped as
    ``shaped``'s, with error feedback in ``err`` (``(1, chunk)`` slots, or
    ``{}``): the wire carries ``q(chunk + err)``, every rank dequantizes the
    same payload."""
    if mode not in QUANTIZED_MODES:
        raise ValueError(f"compressed_all_gather: mode must be one of "
                         f"{QUANTIZED_MODES}, got {mode!r}")
    n, _ = group_size(group)
    c_leaves = [_t(c) for c in tree_leaves(chunks)]
    p_leaves = [_t(p) for p in tree_leaves(shaped)]
    e_leaves = tree_leaves(err)
    if len(p_leaves) != len(c_leaves) or (e_leaves and len(e_leaves) != len(c_leaves)):
        raise ValueError("compressed_all_gather: chunk / shape / error "
                         "trees do not match")
    lay = _layout_of(p_leaves, n, block)
    row = lay.row_join([c.float() for c in c_leaves])
    e_row = lay.row_join([_t(e) for e in e_leaves]) if e_leaves else None
    full, new_err = gather_row(lay, row, group, mode, e_row)
    shapes = [tuple(p.shape) for p in p_leaves]
    out = tree_unflatten(chunks, [t.clone() for t in lay.unpack(full, shapes)])
    if not e_leaves:
        return out, err
    return out, tree_unflatten(err, [e.reshape(1, -1).clone() for e in lay.row_split(new_err)])
