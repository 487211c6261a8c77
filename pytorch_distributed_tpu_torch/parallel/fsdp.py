"""FSDP / ZeRO-3-style parameter sharding over the ``data`` axis, the port of
``pytorch_distributed_tpu/parallel/fsdp.py``.

``fsdp_specs`` is the JAX rule: shard each parameter's largest free
dimension (in the JAX layout, composed over the tensor-parallel table) over
the data group, where the data-axis size divides it, for leaves of at least
``min_size`` elements.  Under GSPMD that layout is all there is; here
``FSDP`` runs it eagerly on a ``TransformerLM`` (``apply_fsdp``):

- each rank keeps only its shard of those parameters (the optimizer, and
  so the momentum, sees the shards: per-rank resident bytes ~1/N);
- each ``Block``'s parameters are all-gathered just before its forward
  (Linear weights in the compute dtype, which every use casts them to, the
  norms in f32), and the tensors autograd saves from them are not kept: a
  saved-tensor hook records where they came from and the backward gathers
  them again, then frees them;
- the gradient of a gathered parameter is reduce-scattered, in f32, so each
  rank receives the sum over the data group of its own shard;
- the update then touches only the rank's shard and momentum.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from pytorch_distributed_tpu_torch.ops import qcomm

MIN_SIZE = 1024


def fsdp_dims(shapes: Mapping[str, Tuple[int, ...]], tp_specs: Mapping[str, object],
              n_shards: int, min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """``{name: torch-layout dimension sharded over data, or None}``: the JAX
    ``fsdp_specs`` on the whole model's ``shapes``, its candidates the
    dimensions the tensor-parallel table leaves free, the largest (then the
    last in the JAX layout) that ``n_shards`` divides."""
    from pytorch_distributed_tpu_torch.utils.convert import _lm_leaf

    out: Dict[str, Optional[int]] = {}
    for name, shape in shapes.items():
        out[name] = None
        size = 1
        for s in shape:
            size *= s
        if n_shards <= 1 or size < min_size:
            continue
        leaf = _lm_leaf(name) if not name.endswith((".w_q", ".scale")) else None
        perm = leaf.perm if leaf is not None and leaf.perm is not None else tuple(
            range(len(shape)))
        taken = getattr(tp_specs.get(name), "dim", None)
        cands = [(shape[perm[j]], j) for j in range(len(shape))
                 if perm[j] != taken and shape[perm[j]] % n_shards == 0]
        if cands:
            out[name] = perm[max(cands)[1]]
    return out


def _gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    stacked = qcomm.all_gather(shard.reshape(-1), group)          # (n, numel)
    return torch.cat(list(stacked.view(-1, *shard.shape).unbind(0)), dim=dim)


class _GatherParam(torch.autograd.Function):
    """The full parameter from every rank's shard, cast to ``dtype``;
    backward: the f32 gradient reduce-scattered back to the shard."""

    @staticmethod
    def forward(ctx, shard, dim, group, dtype):
        ctx.dim, ctx.group = dim, group
        return _gather(shard.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        n = qcomm.group_size(ctx.group)[0]
        parts = torch.stack(g.float().chunk(n, dim=ctx.dim))
        return qcomm.reduce_scatter(parts, ctx.group), None, None, None


class FSDP:
    """The FSDP state of one model: which parameters are sharded, along
    which dimension, over which group; the registry of the gathered
    tensors the current forward may save."""

    def __init__(self, model: torch.nn.Module, dims: Dict[str, Optional[int]], group,
                 rank: int, n: int, compute_dtype: torch.dtype):
        self.model, self.group, self.rank, self.n = model, group, rank, n
        self.dims = {k: d for k, d in dims.items() if d is not None}
        self.dtype = compute_dtype
        # storage pointer -> (name, dtype, the tensor, held so the pointer
        # cannot be reused while registered)
        self._live: Dict[int, Tuple[str, torch.dtype, torch.Tensor]] = {}

    def sharded(self, name: str) -> bool:
        return name in self.dims

    def _dtype_for(self, name: str) -> torch.dtype:
        """Linear weights and biases are used in the compute dtype; norms
        and the embedding's lookup in f32."""
        leaf = name.rsplit(".", 2)
        mod = leaf[-2] if len(leaf) >= 2 else ""
        return self.dtype if mod in ("qkv", "proj", "fc1", "fc2") else torch.float32

    def full(self, name: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Parameter ``name`` whole (gathered when sharded), in ``dtype``."""
        p = self.model.get_parameter(name)
        dtype = dtype or torch.float32
        if name not in self.dims:
            return p if dtype == p.dtype else p.to(dtype)
        t = _GatherParam.apply(p, self.dims[name], self.group, dtype)
        self._live[t.untyped_storage().data_ptr()] = (name, dtype, t)
        return t

    def _regather(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        with torch.no_grad():
            return _gather(self.model.get_parameter(name).detach().to(dtype),
                           self.dims[name], self.group)

    @contextlib.contextmanager
    def saving(self):
        """Inside: a saved tensor that lives in a gathered parameter's
        storage is kept as a recipe and gathered again when the backward
        unpacks it."""
        def pack(t):
            live = self._live.get(t.untyped_storage().data_ptr())
            if live is None:
                return t
            return ("fsdp", live[:2], t.size(), t.stride(), t.storage_offset())

        def unpack(x):
            if isinstance(x, tuple) and len(x) == 5 and x[0] == "fsdp":
                _, (name, dtype), size, stride, offset = x
                return self._regather(name, dtype).as_strided(size, stride, offset)
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            try:
                yield
            finally:
                self._live.clear()

    def call(self, block: torch.nn.Module, prefix: str, *args):
        """``block(*args)`` with its sharded parameters gathered; the
        gathered tensors are dropped from the registry afterwards."""
        full = {k[len(prefix):]: self.full(k, self._dtype_for(k))
                for k in self.dims if k.startswith(prefix)}
        out = functional_call(block, full, args)
        for t in full.values():
            self._live.pop(t.untyped_storage().data_ptr(), None)
        return out

    # ------------------------------------------------------ state dicts
    def shard(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's data shard of each sharded tensor of ``sd``."""
        return {k: (v.chunk(self.n, dim=self.dims[k])[self.rank].contiguous()
                    if k in self.dims else v) for k, v in sd.items()}

    def gather(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of ``shard`` over the data group (a collective)."""
        with torch.no_grad():
            return {k: (_gather(v.detach(), self.dims[k], self.group) if k in self.dims else v)
                    for k, v in sd.items()}


@torch.no_grad()
def apply_fsdp(model, mesh, min_size: int = MIN_SIZE) -> Optional[FSDP]:
    """Shard ``model``'s parameters over ``mesh``'s data axis in place (a
    no-op, returning None, when that axis has size 1) and set
    ``model.fsdp``."""
    from pytorch_distributed_tpu_torch.models.transformer import lm_shapes

    n = mesh.size("data")
    if n <= 1:
        return None
    cfg = model.config
    shapes = lm_shapes(cfg["vocab_size"], cfg["d_model"], cfg["n_layers"], cfg["quant"])
    dims = fsdp_dims(shapes, model.specs, n, min_size)
    plan = FSDP(model, dims, mesh.group("data"), mesh.index("data"), n, model.dtype)
    for name, d in plan.dims.items():
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        old = getattr(mod, attr)
        setattr(mod, attr, torch.nn.Parameter(old.detach().chunk(n, dim=d)[plan.rank].clone(),
                                              requires_grad=old.requires_grad))
    model.fsdp = plan
    return plan
