"""Fused tied-head + cross-entropy, the port of the replicated variant of
``pytorch_distributed_tpu/ops/fused_ce.py``: the LM loss without the
``[N, V]`` logits tensor.

``fused_ce_sums(h, e, targets, weights, num_chunks)`` returns the weighted
``(loss_sum, correct_sum)`` of the tied head ``h @ e.T`` under softmax
cross-entropy, as f32 scalars, through a ``torch.autograd.Function``:

- **forward**: a loop over ``num_chunks`` row blocks.  Each block's logits
  (``[chunk, V]``, f32 accumulation from bf16 or f32 operands) live only
  inside its iteration; only the two scalars survive the loop.
- **saved for the backward**: the inputs only, nothing of size N·V.
- **backward**: recomputes each block's logits and forms ``softmax −
  onehot`` times ``w·ḡ`` in place (the target column is rewritten as
  ``(p − 1)·w·ḡ``; no one-hot is built), then accumulates ``dh`` (cast to
  h's dtype), ``dE`` in one f32 ``[V, D]`` buffer (cast to e's dtype at the
  end) and the weights' cotangent ``(logz − true_logit)·ḡ``.  These two
  products take the f32 ``dlogit`` against f32 copies of ``e`` and ``h``,
  as the JAX ``dot_general`` promotes them.  ``correct_sum`` carries no
  gradient.

N is padded up to a multiple of ``num_chunks`` with weight-0 rows, as the
JAX ``_pad_rows`` does.  The products are PyTorch matmuls, as the JAX
package computes them with ``lax.dot_general`` outside any Pallas kernel.

The JAX module's ``dp`` and ``tp`` variants run on a mesh
(``parallel/mesh.py``), each rank on its own rows, with the collectives
written out where the JAX variants place them inside ``shard_map``:

- ``fused_ce_sums_dp`` (replicated embedding, data axis > 1, vocab divisible
  by it): the backward's ``dE`` accumulator is the rank's vocab rows
  ``[V/k, D]``.  Each block's ``[chunk, V]`` ``dlogit`` goes through one
  all-to-all (row-sharded to vocab-sharded) and the block's hidden rows
  through one all-gather, so each rank sums every rank's rows for its
  slice; the cotangent is the whole ``[V, D]`` with the other slices zero,
  which the step's data all-reduce completes;
- ``fused_ce_sums_tp`` (the vocab-sharded tied embedding of tensor
  parallelism): each block's local ``[chunk, V/tp]`` logits, the global
  max, sum-exp and target logit combined over the model group (argmax ties
  to the lowest global index, ``jnp.argmax``'s), ``logz`` and the target
  logit saved per row; the backward's ``dE`` is the local ``[V/tp, D]``
  and ``dh`` is all-reduced over the model group.

Both return this rank's sums; the train step averages them over the data
group.  ``resolve_fused_ce_mode`` is the JAX rule on the mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32
FUSED_CE_MODES = ("auto", "replicated", "dp", "tp")


def resolve_fused_ce_mode(mode: str, vocab_size: Optional[int] = None, mesh=None,
                          embed_axis: Optional[str] = None) -> str:
    """The JAX ``resolve_fused_ce_mode`` on ``mesh`` (one device without):
    ``tp`` when the tied embedding's vocab rows are split over a mesh axis
    other than ``data`` (``embed_axis``) of size > 1 that divides the
    vocab; ``dp`` when they are not split, the data axis is > 1 and
    divides the vocab; ``replicated`` otherwise.  An explicit mode that
    does not fit raises the JAX error."""
    if mode not in FUSED_CE_MODES:
        raise ValueError(f"fused_ce_mode must be auto|replicated|dp|tp, got {mode!r}")
    shape = mesh.shape if mesh is not None else {}
    spec = f"PartitionSpec({embed_axis!r}, None)" if embed_axis else "PartitionSpec()"
    tp_ok = (embed_axis is not None and embed_axis != "data"
             and shape.get(embed_axis, 1) > 1 and vocab_size is not None
             and vocab_size % shape[embed_axis] == 0)
    dp = shape.get("data", 1)
    dp_ok = (dp > 1 and vocab_size is not None and vocab_size % dp == 0
             and (embed_axis is None or shape.get(embed_axis, 1) == 1))
    where = f"mesh {shape}" if mesh is not None else "one device"
    if mode == "auto":
        return "tp" if tp_ok else ("dp" if dp_ok else "replicated")
    if mode == "tp" and not tp_ok:
        raise ValueError(
            "fused_ce_mode='tp' needs the tied embedding vocab-sharded "
            "over a non-data mesh axis dividing the vocab; got spec "
            f"{spec} on {where} (vocab {vocab_size})")
    if mode == "dp" and not dp_ok:
        raise ValueError(
            "fused_ce_mode='dp' needs a replicated embedding, a data axis "
            f"> 1, and vocab divisible by it; got spec {spec} on {where} "
            f"(vocab {vocab_size})")
    return mode


def _block_logits(hb: torch.Tensor, e: torch.Tensor, e32: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """``[chunk, V]`` f32 logits of one row block: f32 accumulation of the
    operands' products (bf16 products are exact in f32).  ``e32``: an f32
    copy of ``e`` where the operands are multiplied in f32."""
    if e32 is None:
        return torch.mm(hb, e.T, out_dtype=F32)
    return hb.float() @ e32.T


def _e32(e: torch.Tensor) -> Optional[torch.Tensor]:
    """An f32 copy of ``e`` for the forward's products, except for bf16 on
    the card, where cuBLAS writes f32 from bf16 operands directly."""
    if e.dtype == F32:
        return e
    return None if e.is_cuda else e.float()


class _FusedCESums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, e, targets, weights, num_chunks):
        e32 = _e32(e)
        loss = torch.zeros((), dtype=F32, device=h.device)
        correct = torch.zeros((), dtype=F32, device=h.device)
        rows = h.shape[0] // num_chunks
        for hb, tb, wb in zip(h.split(rows), targets.split(rows), weights.split(rows)):
            logits = _block_logits(hb, e, e32)
            logz = torch.logsumexp(logits, dim=-1)
            true_logit = logits.gather(1, tb[:, None])[:, 0]
            loss += ((logz - true_logit) * wb).sum()
            correct += ((logits.argmax(dim=-1) == tb).float() * wb).sum()
        ctx.save_for_backward(h, e, targets, weights)
        ctx.num_chunks = num_chunks
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        h, e, targets, weights = ctx.saved_tensors
        e_f = e.float()
        e32 = _e32(e)
        de = torch.zeros(e.shape, dtype=F32, device=e.device)
        dh, dw = [], []
        rows = h.shape[0] // ctx.num_chunks
        for hb, tb, wb in zip(h.split(rows), targets.split(rows), weights.split(rows)):
            logits = _block_logits(hb, e, e32)
            logz = torch.logsumexp(logits, dim=-1)
            true_logit = logits.gather(1, tb[:, None])[:, 0]
            scale = (wb * g_loss)[:, None]
            # softmax - onehot, times w·ḡ, in the logits' own buffer.
            p = logits.sub_(logz[:, None]).exp_()
            p_true = p.gather(1, tb[:, None])
            dlogit = p.mul_(scale).scatter_(1, tb[:, None], (p_true - 1.0) * scale)
            dh.append((dlogit @ e_f).to(h.dtype))
            de.addmm_(dlogit.T, hb.float())
            dw.append((logz - true_logit) * g_loss)
        return (torch.cat(dh), de.to(e.dtype), None,
                torch.cat(dw).to(weights.dtype), None)


def fused_ce_sums(h: torch.Tensor, e: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, num_chunks: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h [N, D]`` hidden rows, ``e [V, D]`` tied embedding, ``targets
    [N]`` ints, ``weights [N]`` f32 -> ``(loss_sum, correct_sum)`` f32
    scalars (weighted sums; divide by ``weights.sum()`` for means).

    N is padded up to a multiple of ``num_chunks`` with weight-0 rows (zero
    loss, zero gradient).  ``correct_sum`` is non-differentiable;
    ``weights`` gets the loss path's cotangent ``(logz − true_logit)·ḡ``
    per row."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    targets = targets.long()
    pad = (-h.shape[0]) % num_chunks
    if pad:
        h = torch.cat([h, h.new_zeros(pad, h.shape[1])])
        targets = torch.cat([targets, targets.new_zeros(pad)])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    return _FusedCESums.apply(h, e, targets, weights, num_chunks)


def _pad(h, targets, weights, num_chunks):
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    targets = targets.long()
    pad = (-h.shape[0]) % num_chunks
    if pad:
        h = torch.cat([h, h.new_zeros(pad, h.shape[1])])
        targets = torch.cat([targets, targets.new_zeros(pad)])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    return h, targets, weights


class _FusedCESumsDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, e, targets, weights, num_chunks, group):
        loss, correct = _FusedCESums.forward(ctx, h, e, targets, weights, num_chunks)
        ctx.group = group
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        from pytorch_distributed_tpu_torch.ops import qcomm

        h, e, targets, weights = ctx.saved_tensors
        k, rank = qcomm.group_size(ctx.group)
        V, D = e.shape
        vs = V // k
        e_f = e.float()
        e32 = _e32(e)
        de = torch.zeros(vs, D, dtype=F32, device=e.device)
        dh, dw = [], []
        rows = h.shape[0] // ctx.num_chunks
        for hb, tb, wb in zip(h.split(rows), targets.split(rows), weights.split(rows)):
            logits = _block_logits(hb, e, e32)
            logz = torch.logsumexp(logits, dim=-1)
            true_logit = logits.gather(1, tb[:, None])[:, 0]
            scale = (wb * g_loss)[:, None]
            p = logits.sub_(logz[:, None]).exp_()
            p_true = p.gather(1, tb[:, None])
            dlogit = p.mul_(scale).scatter_(1, tb[:, None], (p_true - 1.0) * scale)
            dh.append((dlogit @ e_f).to(h.dtype))
            dw.append((logz - true_logit) * g_loss)
            # Row-sharded -> vocab-sharded: every rank's rows of the block
            # for this rank's vocab slice, against every rank's hidden rows.
            slices = dlogit.reshape(-1, k, vs).transpose(0, 1).contiguous()
            dl_v = qcomm.all_to_all(slices, ctx.group).reshape(-1, vs)
            h_all = qcomm.all_gather(hb.float().reshape(-1), ctx.group).reshape(-1, D)
            de.addmm_(dl_v.T, h_all)
        full = torch.zeros(e.shape, dtype=F32, device=e.device)
        full[rank * vs:(rank + 1) * vs] = de
        return (torch.cat(dh), full.to(e.dtype), None, torch.cat(dw).to(weights.dtype),
                None, None)


def fused_ce_sums_dp(h, e, targets, weights, num_chunks: int, group):
    """The data-sharded variant (module docstring): this rank's rows
    ``h [N, D]``, the replicated ``e [V, D]``; ``(loss_sum, correct_sum)``
    of the rank's rows.  The vocab must divide over the group."""
    from pytorch_distributed_tpu_torch.ops import qcomm

    k = qcomm.group_size(group)[0]
    if k <= 1:
        return fused_ce_sums(h, e, targets, weights, num_chunks)
    if e.shape[0] % k:
        raise ValueError(
            f"fused_ce_sums_dp: vocab {e.shape[0]} not divisible by the "
            f"'data' axis size {k} (needed for the vocab-sharded "
            f"dE accumulator); use the replicated variant")
    h, targets, weights = _pad(h, targets, weights, num_chunks)
    return _FusedCESumsDP.apply(h, e, targets, weights, num_chunks, group)


class _FusedCESumsTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, e, targets, weights, num_chunks, lo, vocab, group):
        from pytorch_distributed_tpu_torch.parallel import tp as tp_lib

        e32 = _e32(e)
        loss = torch.zeros((), dtype=F32, device=h.device)
        correct = torch.zeros((), dtype=F32, device=h.device)
        logzs, tls = [], []
        rows = h.shape[0] // num_chunks
        for hb, tb, wb in zip(h.split(rows), targets.split(rows), weights.split(rows)):
            logits = _block_logits(hb, e, e32)          # [chunk, V/tp]
            logz, true_logit, _, _ = tp_lib._stats(logits, tb, lo, group)
            pred = tp_lib.vocab_parallel_argmax(logits, lo, vocab, group)
            loss += ((logz - true_logit) * wb).sum()
            correct += ((pred == tb).float() * wb).sum()
            logzs.append(logz)
            tls.append(true_logit)
        ctx.save_for_backward(h, e, targets, weights, torch.cat(logzs), torch.cat(tls))
        ctx.num_chunks, ctx.lo, ctx.group = num_chunks, lo, group
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        from pytorch_distributed_tpu_torch.parallel import tp as tp_lib

        h, e, targets, weights, logz, tl = ctx.saved_tensors
        e_f = e.float()
        e32 = _e32(e)
        vloc = e.shape[0]
        de = torch.zeros(e.shape, dtype=F32, device=e.device)
        dh, dw = [], []
        rows = h.shape[0] // ctx.num_chunks
        for hb, tb, wb, lzb, tlb in zip(h.split(rows), targets.split(rows),
                                        weights.split(rows), logz.split(rows), tl.split(rows)):
            logits = _block_logits(hb, e, e32)
            scale = (wb * g_loss)[:, None]
            p = logits.sub_(lzb[:, None]).exp_()
            local = tb - ctx.lo
            own = torch.nonzero((local >= 0) & (local < vloc))[:, 0]
            p[own, local[own]] -= 1.0
            dlogit = p.mul_(scale)
            dh.append(tp_lib.all_reduce_sum(dlogit @ e_f, ctx.group).to(h.dtype))
            de.addmm_(dlogit.T, hb.float())
            dw.append((lzb - tlb) * g_loss)
        return (torch.cat(dh), de.to(e.dtype), None, torch.cat(dw).to(weights.dtype),
                None, None, None, None)


def fused_ce_sums_tp(h, e, targets, weights, num_chunks: int, lo: int, vocab: int, group):
    """The tensor-parallel variant (module docstring): the replicated rows
    ``h [N, D]``, this rank's vocab rows ``e [V/tp, D]`` starting at global
    index ``lo`` of ``vocab``; ``(loss_sum, correct_sum)`` of the rows."""
    if group is None:
        return fused_ce_sums(h, e, targets, weights, num_chunks)
    h, targets, weights = _pad(h, targets, weights, num_chunks)
    return _FusedCESumsTP.apply(h, e, targets, weights, num_chunks, lo, vocab, group)
