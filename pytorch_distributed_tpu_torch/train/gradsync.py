"""The gradient-communication stack of a train step (``--grad-compress
int8|fp8``, ``--zero wus``, ``--overlap bucketed``): what the JAX package's
``train/steps.py`` and ``train/lm.py`` do with ``ops/qcomm.py``,
``parallel/zero.py`` and ``parallel/overlap.py`` inside their compiled
steps, as stages the port's eager steps call.

``GradSync`` sees the model's parameters as the leaves of the JAX
``params`` tree (``utils/convert.py::jax_leaves``: that order, and each
leaf viewed in the JAX layout, so conv kernels quantize in HWIO blocks as
there).  The leaves are split into buckets (``overlap.plan_buckets``; one
bucket without ``--overlap bucketed``), each packed into one buffer
(``qcomm.PackedLayout``), so a bucket makes one collective of each kind.
It holds the state JAX keeps in ``TrainState``: the error-feedback
residual (per rank, leaf-major per bucket, on the explicit step;
replicated and param-shaped for the emulation), and under ``wus`` this
rank's rows of the momentum, of the quantized gather's error (``agerr``)
and of the deferred gather's ``pending`` delta.

- ``explicit`` (the JAX ``local_step``): the local gradient sums all-reduced
  per bucket, f32, bf16 or through the quantized all-reduce; with hooks, a
  bucket's collective starts (``async_op=True``) from
  ``register_post_accumulate_grad_hook`` as its last gradient of the last
  microbatch lands, and everything is waited for before the division.
- the emulation (the GSPMD twin and the LM's step): the synced, averaged
  gradient fake-quantized with error feedback; no fewer bytes move.
- ``wus``: the reduce-scatter (f32, bf16, quantized; GSPMD twin: f32, or
  the all-reduce and the emulation under a quantized mode, which needs the
  whole gradient), the reference SGD on this rank's row with
  ``torch.optim.SGD``'s own operations, then the all-gather: of the new
  parameters on an f32 wire (so the result is the replicated step's to the
  bit), of the delta ``lr * buf`` on a bf16 or quantized wire (the JAX
  rule), or staged as ``pending`` and gathered at the head of the next
  step (``deferred``).

Without a group every collective is local (one rank), and the arithmetic
is the JAX step's on a one-device mesh.  The stages are the packed ones of
``ops/qcomm.py`` and ``parallel/zero.py`` that the JAX-API functions there
(``compressed_psum``, ``compress_emulated``, ``reduce_scatter_grads``,
``wus_update_chunks``, ``wus_gather_deltas``, ``gather_momentum``, ...)
are built from, so their one-rank bitwise tests hold this code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.fused_bn import all_reduce_sum
from pytorch_distributed_tpu_torch.parallel import overlap as overlap_lib
from pytorch_distributed_tpu_torch.parallel import zero as zero_lib
from pytorch_distributed_tpu_torch.utils.convert import jax_leaves, tree_at, tree_from_leaves


class _Bucket:
    def __init__(self, index: Sequence[int], lay: qcomm.PackedLayout):
        self.index, self.lay = list(index), lay
        self.residual: Optional[torch.Tensor] = None   # leaf-major, explicit quantized
        self.buf = self.agerr = self.pending = None    # rows, under wus
        self.ctx: Optional[dict] = None                # a launched collective


class GradSync:
    """See the module docstring.  ``model``'s parameters are the f32
    master weights the optimizer updates."""

    def __init__(self, model: torch.nn.Module, group, *, mode: str, cast_dtype,
                 explicit: bool, zero: str = "none", overlap: str = "none",
                 bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB, wus_gather: str = "eager",
                 block: int = qcomm.DEFAULT_BLOCK):
        self.leaves = jax_leaves(model)
        named = dict(model.named_parameters())
        self.params = [named[leaf.name] for leaf in self.leaves]
        self.shapes = [tuple(leaf.to_jax(p).shape) for leaf, p in zip(self.leaves, self.params)]
        self.group = group
        self.n, self.rank = qcomm.group_size(group)
        self.mode, self.cast = mode, cast_dtype
        self.quantized = mode in qcomm.QUANTIZED_MODES
        self.explicit, self.wus = explicit, zero == "wus"
        self.deferred = wus_gather == "deferred"
        bucketed = overlap == "bucketed"
        index = (overlap_lib.plan_buckets(self.params, bucket_mb) if bucketed
                 else [list(range(len(self.params)))])
        self.buckets = [_Bucket(ix, qcomm.PackedLayout([self.params[i].numel() for i in ix],
                                                       self.n, block))
                        for ix in index]
        dev = self.params[0].device
        # The emulation quantizes whole leaves: one rank's layout, blocks of
        # ``block`` over each padded leaf, as ``fake_quantize``.
        self.emulate = self.quantized and not explicit
        self.emu = (qcomm.PackedLayout([p.numel() for p in self.params], 1, block)
                    if self.emulate else None)
        self.emu_residual = (torch.zeros(self.emu.numel, device=dev) if self.emulate else None)
        for b in self.buckets:
            if explicit and self.quantized:
                b.residual = torch.zeros(b.lay.numel, device=dev)
            if self.wus:
                b.buf = torch.zeros(b.lay.row, device=dev)
                if explicit and self.quantized:
                    b.agerr = torch.zeros(b.lay.row, device=dev)
                if self.deferred:
                    b.pending = torch.zeros(b.lay.row, device=dev)
        self.bucket_of = {i: k for k, b in enumerate(self.buckets) for i in b.index}
        # Overlap: a bucket's collective starts from the hook of its last
        # gradient, on the last microbatch (``arm``) only.
        self.hooked = bucketed and explicit and group is not None
        self._armed, self._left = False, []
        if self.hooked:
            for i, p in enumerate(self.params):
                p.register_post_accumulate_grad_hook(self._hook(i))

    # ---------------------------------------------------------- per step
    def _hook(self, i: int):
        def fn(_):
            if self._armed:
                k = self.bucket_of[i]
                self._left[k] -= 1
                if self._left[k] == 0:
                    self._launch(self.buckets[k])
        return fn

    def arm(self, on: bool) -> None:
        """Let the hooks launch during the coming backward (the last
        microbatch's) or not."""
        self._armed = on and self.hooked
        if self._armed:
            self._left = [len(b.index) for b in self.buckets]

    def _grads(self, b: _Bucket) -> List[Optional[torch.Tensor]]:
        return [None if self.params[i].grad is None else
                self.leaves[i].to_jax(self.params[i].grad) for i in b.index]

    def _launch(self, b: _Bucket) -> None:
        """Start bucket ``b``'s collective on the local gradient sums."""
        dev = self.params[0].device
        if self.quantized and self.explicit:
            b.ctx = qcomm.psum_start(b.lay, b.lay.pack(self._grads(b), dev), b.residual,
                                     self.group, self.mode)
        elif self.wus:   # f32 or bf16 (the GSPMD twin's quantized wus syncs in wus_step)
            b.ctx = qcomm.scatter_start(b.lay, b.lay.pack(self._grads(b), dev), self.group,
                                        self.cast if self.explicit else None)
        else:
            b.ctx = qcomm.sum_start([self._grad_or_zeros(i) for i in b.index], self.group,
                                    self.cast)

    def _grad_or_zeros(self, i: int) -> torch.Tensor:
        p = self.params[i]
        return torch.zeros_like(p) if p.grad is None else p.grad

    def launch_rest(self) -> None:
        """Start every bucket the hooks did not (all of them without)."""
        self._armed = False
        for b in self.buckets:
            if b.ctx is None:
                self._launch(b)

    def sync_explicit(self, count: torch.Tensor) -> None:
        """Finish the explicit all-reduce: each gradient becomes the f32 sum
        over the ranks divided by ``count`` (the JAX ``local_step``)."""
        self.launch_rest()
        for b in self.buckets:
            ctx, b.ctx = b.ctx, None
            if self.quantized:
                summed, b.residual = qcomm.psum_finish(b.lay, ctx, self.group, self.rank,
                                                       self.mode, True)
                views = [self.leaves[i].from_jax(v) for i, v in
                         zip(b.index, b.lay.unpack(summed, [self.shapes[i] for i in b.index]))]
            else:
                views = [v.float() for v in
                         qcomm.sum_finish(ctx, [self.params[i].shape for i in b.index])]
            for i, g in zip(b.index, views):
                self.params[i].grad = torch.div(g, count, out=torch.empty_like(self.params[i]))

    def emulate_grads(self) -> None:
        """The emulation on the synced, averaged ``.grad``s: fake-quantized
        with error feedback (``qcomm.compress_emulated``), in place."""
        x = self.emu.pack(self._all_grads(), self.params[0].device)
        out, self.emu_residual = qcomm.emulate(self.emu, x, self.emu_residual, self.mode)
        for i, v in enumerate(self.emu.unpack(out, self.shapes)):
            self.params[i].grad.copy_(self.leaves[i].from_jax(v))

    def _all_grads(self) -> List[Optional[torch.Tensor]]:
        return [None if p.grad is None else leaf.to_jax(p.grad)
                for leaf, p in zip(self.leaves, self.params)]

    def wus_step(self, count: torch.Tensor, lr: float, momentum: float, weight_decay: float,
                 want_norm: bool) -> Optional[torch.Tensor]:
        """The weight-update-sharded step after the backward: this rank's
        rows of the averaged gradient (``wus_rows``), the twin's cast, then
        ``wus_update``.  Returns the global gradient norm when ``want_norm``
        (of the gradient the update takes, as the image steps log it)."""
        rows = self.wus_rows(count)
        if not self.explicit and self.cast is not None:
            rows = [row.to(self.cast).float() for row in rows]
        gnorm = None
        if want_norm:
            if self.quantized and not self.explicit:
                gnorm = torch.stack([p.grad.float().square().sum() for p in self.params]).sum()
            else:
                gnorm = all_reduce_sum(zero_lib.chunk_sq_sum(rows), self.group)
            gnorm = gnorm.sqrt()
        self.wus_update(rows, lr, momentum, weight_decay)
        return gnorm

    def wus_rows(self, count: torch.Tensor) -> List[torch.Tensor]:
        """This rank's rows of the gradient summed over the ranks and divided
        by ``count``, one per bucket: the reduce-scatter (on the explicit
        step's wire); the GSPMD twin under a quantized mode all-reduces,
        emulates on the whole gradient and takes its rows."""
        if self.quantized and not self.explicit:
            summed = qcomm.sum_finish(
                qcomm.sum_start([self._grad_or_zeros(i) for i in range(len(self.params))],
                                self.group), [p.shape for p in self.params])
            for p, g in zip(self.params, summed):
                p.grad = torch.div(g, count, out=torch.empty_like(p))
            self.emulate_grads()
            return self.grad_rows()
        self.launch_rest()
        rows = []
        for b in self.buckets:
            ctx, b.ctx = b.ctx, None
            if self.quantized:
                row = qcomm.owned_sum(b.lay, ctx)
                b.residual = qcomm.stage1_error(b.lay, ctx)
            else:
                row = qcomm.scatter_finish(ctx)
            rows.append(row / count)
        return rows

    def grad_rows(self) -> List[torch.Tensor]:
        """This rank's rows of the ``.grad``s as they stand (already synced)."""
        dev = self.params[0].device
        return [b.lay.own_row(self._grads(b), self.rank, dev) for b in self.buckets]

    def wus_update(self, rows: Sequence[torch.Tensor], lr: float, momentum: float,
                   weight_decay: float) -> None:
        """The SGD on this rank's ``rows`` of the gradient and of the
        momentum, then the all-gather of the new parameters (or of the
        delta, or staged as ``pending``)."""
        dev = self.params[0].device
        for b, row in zip(self.buckets, rows):
            p_row = b.lay.own_row([self.leaves[i].to_jax(self.params[i].detach())
                                   for i in b.index], self.rank, dev)
            buf = zero_lib.sgd_chunk(row, p_row, b.buf, momentum, weight_decay)
            if self.deferred:
                b.pending = buf * lr
            elif self.explicit and self.quantized:
                full, b.agerr = qcomm.gather_row(b.lay, buf * lr, self.group, self.mode, b.agerr)
                self._apply(b, full, subtract=True)
            elif self.explicit and self.cast is not None:
                self._apply(b, qcomm.gather_flat(b.lay, buf * lr, self.group, self.cast),
                            subtract=True)
            else:
                self._apply(b, qcomm.gather_flat(b.lay, p_row.add(buf, alpha=-lr), self.group),
                            subtract=False)

    @torch.no_grad()
    def _apply(self, b: _Bucket, full: torch.Tensor, subtract: bool) -> None:
        for i, v in zip(b.index, b.lay.unpack(full, [self.shapes[i] for i in b.index])):
            p = self.leaves[i].to_jax(self.params[i].data)
            if subtract:
                p.sub_(v)
            else:
                p.copy_(v)

    def drain(self) -> None:
        """The head of a deferred step: gather every rank's staged delta
        (on the step's wire) and subtract it; ``pending`` is then zero."""
        for b in self.buckets:
            self._apply(b, qcomm.gather_flat(b.lay, b.pending, self.group, self.cast),
                        subtract=True)
            b.pending = torch.zeros_like(b.pending)

    def materialize(self) -> None:
        """Apply the staged deltas now (before an eval or a checkpoint under
        the deferred gather; every rank calls it); a no-op otherwise."""
        if self.deferred:
            self.drain()

    # ----------------------------------------------------------- state
    def state_tensors(self) -> List[torch.Tensor]:
        """Every state tensor (what ``guard_nonfinite`` restores)."""
        out = [self.emu_residual] if self.emulate else []
        for b in self.buckets:
            out += [t for t in (b.residual, b.buf, b.agerr, b.pending) if t is not None]
        return out

    def set_state_tensors(self, tensors: Sequence[torch.Tensor]) -> None:
        it = iter(tensors)
        if self.emulate:
            self.emu_residual = next(it)
        for b in self.buckets:
            for name in ("residual", "buf", "agerr", "pending"):
                if getattr(b, name) is not None:
                    setattr(b, name, next(it))

    def _gathered_momentum(self) -> List[np.ndarray]:
        """Every rank's momentum rows gathered to the param-shaped JAX-layout
        leaves (host f32): each leaf's ``(n, chunk)`` slice of the gathered
        rows is the JAX stacked layout ``zero.gather_momentum`` takes.  A
        collective."""
        out: List[Optional[np.ndarray]] = [None] * len(self.params)
        for b in self.buckets:
            stacked = b.lay.row_split(qcomm.all_gather(b.buf, self.group).cpu().numpy().copy())
            shaped = [np.broadcast_to(np.float32(0), self.shapes[i]) for i in b.index]
            for i, m in zip(b.index, zero_lib.gather_momentum({"buf": stacked}, shaped)):
                out[i] = m
        return out

    def checkpoint_trees(self) -> Dict[str, Optional[dict]]:
        """``{"momentum", "residual"}`` as the JAX checkpoint stores them
        (None where this step keeps none): the param-shaped momentum
        gathered from the ranks' rows under ``wus``, the residual stacked
        ``(n, *shape)`` over the ranks on the explicit step or param-shaped
        for the emulation.  A collective: every rank calls it."""
        paths = [leaf.path for leaf in self.leaves]
        out: Dict[str, Optional[dict]] = {"momentum": None, "residual": None}
        if self.wus:
            out["momentum"] = tree_from_leaves(paths, self._gathered_momentum())
        if self.emulate:
            out["residual"] = tree_from_leaves(
                paths, [v.detach().cpu().numpy().copy()
                        for v in self.emu.unpack(self.emu_residual, self.shapes)])
        elif self.explicit and self.quantized:
            res: List[Optional[np.ndarray]] = [None] * len(self.params)
            for b in self.buckets:
                stacked = qcomm.all_gather(b.residual, self.group)   # (n, numel)
                for j, i in enumerate(b.index):
                    a = b.lay.off[j]
                    res[i] = stacked[:, a:a + b.lay.sizes[j]].reshape(
                        (self.n,) + self.shapes[i]).cpu().numpy().copy()
            out["residual"] = tree_from_leaves(paths, res)
        return out

    def load(self, momentum: Optional[dict], residual: Optional[dict]) -> None:
        """Restore from the trees a checkpoint holds: the param-shaped
        momentum re-chunked into this rank's rows under ``wus`` (``agerr``
        and ``pending`` start at zero); the residual when its shapes are
        this step's (the same mode and world), else zeros, as JAX resets
        error feedback on a mode or mesh switch."""
        dev = self.params[0].device
        if self.wus and momentum is not None:
            for b in self.buckets:
                leaves = []
                for i in b.index:
                    m = np.asarray(tree_at(momentum, self.leaves[i].path), np.float32)
                    if m.shape != self.shapes[i]:
                        raise ValueError(f"checkpoint momentum {self.leaves[i].name} is "
                                         f"{m.shape}, the model's {self.shapes[i]}")
                    leaves.append(m)
                template = [np.broadcast_to(np.float32(0), (self.n, c)) for c in b.lay.chunk]
                stacked = zero_lib.shard_momentum(leaves, template)
                b.buf = b.lay.row_join([torch.from_numpy(c[self.rank]) for c in stacked]).to(dev)
                if b.agerr is not None:
                    b.agerr = torch.zeros_like(b.agerr)
                if b.pending is not None:
                    b.pending = torch.zeros_like(b.pending)
        want = [((self.n,) if self.explicit else ()) + s for s in self.shapes]
        saved = None
        if residual:
            try:
                saved = [np.asarray(tree_at(residual, leaf.path), np.float32)
                         for leaf in self.leaves]
            except (KeyError, TypeError):
                saved = None
            if saved is not None and [a.shape for a in saved] != want:
                saved = None
        if self.emulate:
            self.emu_residual = (torch.zeros_like(self.emu_residual) if saved is None else
                                 self.emu.pack([torch.from_numpy(a) for a in saved], dev))
        elif self.explicit and self.quantized:
            for b in self.buckets:
                b.residual = (torch.zeros_like(b.residual) if saved is None else
                              b.lay.pack([torch.from_numpy(saved[i][self.rank])
                                          for i in b.index], dev))


def momentum_bytes(optimizer: torch.optim.Optimizer, comm: Optional[GradSync] = None) -> int:
    """Bytes of momentum this rank holds: every ``momentum_buffer`` tensor
    in ``optimizer``'s state and, under ``wus``, ``comm``'s rows."""
    held = [st.get("momentum_buffer") for st in optimizer.state.values()]
    if comm is not None:
        held += [b.buf for b in comm.buckets]
    return sum(t.numel() * t.element_size() for t in held if t is not None)
