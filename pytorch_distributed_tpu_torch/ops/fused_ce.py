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

The JAX module's ``dp`` and ``tp`` variants shard the ``dE`` accumulator
over a mesh; the port trains the LM on one device, so
``resolve_fused_ce_mode`` keeps the JAX rules for one device (``auto`` is
``replicated``, an explicit ``dp`` or ``tp`` raises the JAX error) and
those variants wait for the parallel layouts (ROADMAP.md item A10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32
FUSED_CE_MODES = ("auto", "replicated", "dp", "tp")


def resolve_fused_ce_mode(mode: str, vocab_size: Optional[int] = None) -> str:
    """The JAX ``resolve_fused_ce_mode`` on one device: ``auto`` and
    ``replicated`` give ``replicated``; ``dp`` and ``tp`` need a data or
    model axis larger than one and raise here with the JAX message."""
    if mode not in FUSED_CE_MODES:
        raise ValueError(f"fused_ce_mode must be auto|replicated|dp|tp, got {mode!r}")
    if mode == "tp":
        raise ValueError(
            "fused_ce_mode='tp' needs the tied embedding vocab-sharded "
            "over a non-data mesh axis dividing the vocab; got one device "
            f"(vocab {vocab_size})")
    if mode == "dp":
        raise ValueError(
            "fused_ce_mode='dp' needs a replicated embedding, a data axis "
            f"> 1, and vocab divisible by it; got one device (vocab {vocab_size})")
    return "replicated"


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
