"""Megatron tensor parallelism over a mesh's ``model`` axis, the port of
``pytorch_distributed_tpu/parallel/tp.py``.

The JAX package states the layout as GSPMD sharding specs and lets XLA
place the collectives; here the layout is a table that says, for each
TransformerLM parameter, which dimension is split over the ``model`` group
and which of its indices each rank holds (``tp_specs``), and the model
(``models/transformer.py``) runs the collectives itself through the
autograd functions below:

- attention ``qkv``: column-parallel, by head group.  The JAX kernel is
  ``[C, 3C]``, split ``[q | k | v]``, so rank r holds the columns of its
  heads in each third (``{q, k, v}[heads_r · D]``), not a contiguous part;
- attention ``proj``: row-parallel (its input rows are the rank's heads);
- MLP ``fc1``: column-parallel, its bias with it (GSPMD keeps the bias
  replicated and slices it; the port stores the slice, Megatron's layout);
- MLP ``fc2``: row-parallel, its bias replicated and added once, after the
  all-reduce;
- the embedding: vocab-sharded, the tied head computing ``[.., V/tp]``
  logits; norms replicated.

A dimension splits into near-equal contiguous parts (the first ``n % tp``
one longer), heads at head boundaries.  Where the JAX package cannot place
a leaf (GSPMD needs every sharded dimension divisible by the axis), the
port refuses it with the JAX words (``check_tp``); a head count that does
not divide runs, as it does under GSPMD.

``shard_state`` slices a full parameter (or momentum) state dict into this
rank's part; ``gather_state`` is its inverse over the group, giving the
full tensors (the JAX layout's values) back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.ops import qcomm

_COLUMN_PARALLEL = ("qkv", "fc1")
_ROW_PARALLEL = ("proj", "fc2")


def split_sizes(n: int, parts: int) -> List[int]:
    """``n`` in ``parts`` near-equal contiguous pieces, the first ``n % parts``
    one longer."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of piece ``index`` of ``split_sizes(n, parts)``."""
    sizes = split_sizes(n, parts)
    lo = sum(sizes[:index])
    return lo, lo + sizes[index]


@dataclasses.dataclass(frozen=True)
class Split:
    """One parameter's split: torch-layout dimension ``dim`` and, per rank,
    the indices along it that the rank holds."""

    dim: int
    parts: Tuple[Tuple[int, ...], ...]

    def of(self, rank: int) -> Tuple[int, ...]:
        return self.parts[rank]

    @property
    def full(self) -> int:
        return sum(len(p) for p in self.parts)


def _contiguous(n: int, tp: int, dim: int) -> Split:
    parts = []
    for r in range(tp):
        lo, hi = split_range(n, tp, r)
        parts.append(tuple(range(lo, hi)))
    return Split(dim, tuple(parts))


def _heads(n_heads: int, head_dim: int, tp: int, dim: int, thirds: bool) -> Split:
    """Head-group columns: rank r's heads' ``head_dim`` columns, in each of
    the ``q | k | v`` thirds when ``thirds``."""
    C = n_heads * head_dim
    parts = []
    for r in range(tp):
        lo, hi = split_range(n_heads, tp, r)
        cols = range(lo * head_dim, hi * head_dim)
        if thirds:
            parts.append(tuple(t * C + c for t in range(3) for c in cols))
        else:
            parts.append(tuple(cols))
    return Split(dim, tuple(parts))


def tp_specs(shapes: Mapping[str, Tuple[int, ...]], n_heads: int, tp: int
             ) -> Dict[str, Optional[Split]]:
    """``{parameter name: Split or None (replicated)}`` for the full
    TransformerLM's ``shapes`` (``name -> torch shape``) over ``tp`` ranks.
    Torch layouts: a Linear's weight is ``[out, in]``."""
    specs: Dict[str, Optional[Split]] = {}
    for name, shape in shapes.items():
        parts = name.split(".")
        module = parts[-2] if len(parts) >= 2 else ""
        spec = None
        if tp > 1:
            if name == "embed.weight":
                spec = _contiguous(shape[0], tp, 0)
            elif module == "qkv" and parts[-1] in ("weight", "w_q", "scale"):
                spec = _heads(n_heads, shape[0] // (3 * n_heads), tp, 0, thirds=True)
            elif module == "proj" and parts[-1] in ("weight", "w_q"):
                spec = _heads(n_heads, shape[1] // n_heads, tp, 1, thirds=False)
            elif module == "fc1" and parts[-1] in ("weight", "w_q", "scale", "bias"):
                spec = _contiguous(shape[0], tp, 0)
            elif module == "fc2" and parts[-1] in ("weight", "w_q"):
                spec = _contiguous(shape[1], tp, 1)
        specs[name] = spec
    return specs


def _jax_spec(name: str) -> Optional[Tuple[int, str]]:
    """The JAX ``transformer_tp_spec`` of a float leaf as ``(jax dim, its
    PartitionSpec repr)``, or None (replicated)."""
    parts = name.split(".")
    if name == "embed.weight":
        return 0, "PartitionSpec('model', None)"
    if parts[-1] == "weight" and len(parts) >= 2 and parts[-2] in _COLUMN_PARALLEL:
        return 1, "PartitionSpec(None, 'model')"
    if parts[-1] == "weight" and len(parts) >= 2 and parts[-2] in _ROW_PARALLEL:
        return 0, "PartitionSpec('model', None)"
    return None


def check_tp(shapes: Mapping[str, Tuple[int, ...]], dp: int, tp: int) -> None:
    """Refuse, with the JAX package's words, a shape its device placement
    refuses: a leaf whose ``model``-sharded dimension ``tp`` does not
    divide (checked in the JAX tree's leaf order)."""
    from pytorch_distributed_tpu_torch.utils.convert import _lm_leaf

    if tp <= 1:
        return
    for leaf in sorted((_lm_leaf(n) for n in shapes), key=lambda leaf: leaf.path):
        found = _jax_spec(leaf.name)
        if found is None:
            continue
        dim, spec = found
        shape = tuple(shapes[leaf.name])
        jshape = shape if leaf.perm is None else tuple(shape[d] for d in leaf.perm)
        if jshape[dim] % tp:
            raise ValueError(
                "One of device_put args was given the sharding of NamedSharding(mesh="
                f"Mesh('data': {dp}, 'model': {tp}, axis_types=(Auto, Auto)), spec={spec}, "
                f"memory_kind=device), which implies that the global size of its dimension "
                f"{dim} should be divisible by {tp}, but it is equal to {jshape[dim]} "
                f"(full shape: {jshape})")


def _index(split: Split, rank: int, device) -> torch.Tensor:
    return torch.tensor(split.of(rank), dtype=torch.long, device=device)


def shard_tensor(t: torch.Tensor, split: Optional[Split], rank: int) -> torch.Tensor:
    """This rank's part of the full ``t`` (a contiguous copy; ``t`` itself
    when replicated)."""
    if split is None:
        return t
    return t.index_select(split.dim, _index(split, rank, t.device)).contiguous()


def shard_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[Split]],
                rank: int) -> Dict[str, torch.Tensor]:
    """A full state dict (parameters, or their momentum) sliced into rank
    ``rank``'s part (the port of ``shard_pytree`` / ``shard_state``)."""
    return {k: shard_tensor(v, specs.get(k), rank) for k, v in state.items()}


def gather_tensor(local: torch.Tensor, split: Optional[Split], group) -> torch.Tensor:
    """The full tensor from every rank's part (a collective over ``group``;
    ``local`` itself when replicated).  Uneven parts travel padded to the
    longest."""
    if split is None or group is None:
        return local
    n = len(split.parts)
    longest = max(len(p) for p in split.parts)
    pad = longest - local.shape[split.dim]
    if pad:
        shape = list(local.shape)
        shape[split.dim] = pad
        local = torch.cat([local, local.new_zeros(shape)], dim=split.dim)
    stacked = qcomm.all_gather(local.reshape(-1), group).view(-1, *local.shape)
    full_shape = list(local.shape)
    full_shape[split.dim] = split.full
    out = local.new_empty(full_shape)
    for r in range(n):
        part = stacked[r].narrow(split.dim, 0, len(split.of(r)))
        out.index_copy_(split.dim, _index(split, r, out.device), part)
    return out


def gather_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[Split]],
                 group) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state`` over ``group`` (every rank calls it,
    every rank gets the full tensors)."""
    return {k: gather_tensor(v, specs.get(k), group) for k, v in state.items()}


# ------------------------------------------------- the Megatron collectives

def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in f32, back in ``x``'s dtype."""
    y = x.float().contiguous() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation
    entering a column-parallel layer (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: a row-parallel layer's partial
    sums made whole (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


def _stats(logits: torch.Tensor, targets: torch.Tensor, lo: int, group):
    """Per row of the local ``[N, V/tp]`` f32 logits: the global ``logz`` and
    the target's logit (from its owning shard)."""
    vloc = logits.shape[-1]
    lmax = all_reduce_max(logits.max(dim=-1).values, group)
    ssum = all_reduce_sum(torch.exp(logits - lmax[:, None]).sum(dim=-1), group)
    logz = lmax + torch.log(ssum)
    tloc = targets.long() - lo
    own = (tloc >= 0) & (tloc < vloc)
    part = logits.gather(1, tloc.clamp(0, vloc - 1)[:, None])[:, 0]
    true_logit = all_reduce_sum(torch.where(own, part, torch.zeros_like(part)), group)
    return logz, true_logit, tloc, own


class _VocabParallelCE(torch.autograd.Function):
    """Per-row ``logz - true_logit`` of vocab-sharded logits: global max and
    sum-exp over the group, the target logit from its owning shard;
    backward ``softmax - onehot`` on the local columns."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        logz, true_logit, tloc, own = _stats(logits, targets, lo, group)
        ctx.save_for_backward(logits, logz, tloc, own)
        return logz - true_logit

    @staticmethod
    def backward(ctx, g):
        logits, logz, tloc, own = ctx.saved_tensors
        d = torch.exp(logits - logz[:, None])
        rows = torch.nonzero(own)[:, 0]
        d[rows, tloc[rows]] -= 1.0
        return d * g[:, None], None, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, lo: int, group
                      ) -> torch.Tensor:
    """Per-row cross-entropy of the local ``[N, V/tp]`` logits (f32) whose
    first column is global vocab index ``lo``."""
    return _VocabParallelCE.apply(logits.float(), targets, lo, group)


@torch.no_grad()
def vocab_parallel_argmax(logits: torch.Tensor, lo: int, vocab: int, group) -> torch.Tensor:
    """The global argmax over the last dimension of vocab-sharded logits,
    ties to the lowest global index (``jnp.argmax``'s first occurrence): the
    shards holding the global max propose their first local index; the
    smallest proposal wins."""
    lmax_loc, amax_loc = logits.max(dim=-1)
    lmax = all_reduce_max(lmax_loc, group)
    cand = torch.where(lmax_loc >= lmax, amax_loc + lo, torch.full_like(amax_loc, vocab))
    return all_reduce_min(cand, group)


class _GatherParam(torch.autograd.Function):
    """A whole parameter from every rank's part; backward: this rank's part
    of the gradient (the same on every rank of the group, whose inputs
    are replicated)."""

    @staticmethod
    def forward(ctx, local, split, group):
        ctx.split, ctx.rank = split, dist.get_rank(group)
        return gather_tensor(local, split, group)

    @staticmethod
    def backward(ctx, g):
        return shard_tensor(g, ctx.split, ctx.rank), None, None


def gather_param(local: torch.Tensor, split: Optional[Split], group) -> torch.Tensor:
    """``gather_tensor`` under autograd: the replicated use of a sharded
    parameter."""
    if split is None or group is None:
        return local
    return _GatherParam.apply(local, split, group)


def gather_vocab(logits: torch.Tensor, split: Split, group) -> torch.Tensor:
    """The full ``[..., V]`` logits from every rank's vocab shard."""
    flat = logits.reshape(-1, logits.shape[-1])
    full = gather_tensor(flat, Split(1, split.parts), group)
    return full.reshape(*logits.shape[:-1], split.full)


def sq_sum_weights(names: Sequence[str], specs: Mapping[str, Optional[Split]],
                   model_rank: int, data_sharded: Sequence[bool] = (),
                   data_rank: int = 0) -> List[float]:
    """Per parameter, 1.0 where this rank's square sum counts towards a
    norm summed over the whole mesh, else 0.0: a leaf replicated over an
    axis counts on that axis's rank 0 only, so each element counts once."""
    out = []
    for i, n in enumerate(names):
        on_model = specs.get(n) is not None or model_rank == 0
        on_data = (data_sharded[i] if data_sharded else False) or data_rank == 0
        out.append(1.0 if on_model and on_data else 0.0)
    return out

