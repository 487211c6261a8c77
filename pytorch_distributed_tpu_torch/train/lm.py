"""Language-model pretraining, on one device or across ranks: the port of
``pytorch_distributed_tpu/train/lm.py``.

- ``SyntheticTokenDataset`` (a learnable affine token process, the LM smoke
  oracle), ``TextFileDataset`` (byte-level LM over files), the step-indexed
  wrap-around batching (``rows=``: one rank's rows only) and
  ``warmup_cosine_lr``: copies of the JAX module's, numpy in and out, so
  both packages see the same tokens.
- ``make_lm_train_step``: next-token cross-entropy and accuracy (through
  the fused tied-head loss of ``ops/fused_ce.py`` with
  ``fused_ce_chunks``), optional global-norm clipping (the JAX formula) and
  strided gradient accumulation, then the reference SGD
  (``train/optim.py``).  The JAX step returns a new
  train state; this one updates the model's f32 parameters and the
  optimizer's momentum in place.
- ``make_lm_eval_step``: exact token-weighted sums for the held-out eval.
- ``LMTrainer``: the step-driven loop with meters, periodic display,
  interval and final eval, the best perplexity, and checkpoints in the JAX
  package's format (``train/checkpoint.py``): every ``save_steps`` and at the
  end of ``fit`` into ``checkpoint_dir``, and ``resume`` to the exact step.

Across ranks (a ``parallel/mesh.py`` mesh, ``data × model``) the step keeps
the JAX GSPMD step's semantics: each rank trains on its data index's
contiguous rows of the global batch (``_row_span``), loss and accuracy are
means over the global batch, the gradients are summed over the data group
(FSDP: reduce-scattered), the global norm counts every element once, and
rank 0 writes the whole model's checkpoint, which any mesh loads.

The gradient-communication stack (``train/gradsync.py``): ``grad_compress``
``bf16`` / ``int8`` / ``fp8`` is the numerics emulation on the averaged,
clipped gradient, with a param-shaped error-feedback residual (a sharded
model gathers each leaf whole first, so the blocks are JAX's, under
``zero="wus"`` too); ``overlap=
"bucketed"`` takes the port of the JAX explicit pure-DP step, the gradient
synced per bucket over the data group (quantized twice under int8/fp8, the
residual stacked per rank) and clipped after; ``zero="wus"`` keeps the
momentum in chunks over the data group (GSPMD's weight-update sharding;
FSDP already shards it).  The residual rides in checkpoints.

The metrics stream (``train/observe.py``): ``metrics_jsonl`` (a record
per step with the step's norms), ``hb_dir`` / ``hb_interval_s``, ``mfu``
(``lm_step_cost_for`` with the fused-CE tax, over the mesh's ranks),
``goodput`` and ``step_attr``, with the JAX ``LMTrainer``'s names and
meanings; each step runs inside an ``lm_step`` span.

Not ported yet (ROADMAP.md queue A): sequence, expert and pipeline
parallelism, the fault-tolerance layer, the observability layer beyond the
metrics stream, elastic membership and the background feeder thread.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.obs.flops import lm_step_cost_for
from pytorch_distributed_tpu_torch.obs.trace import scope
from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.fused_ce import (
    fused_ce_sums,
    fused_ce_sums_dp,
    fused_ce_sums_tp,
    resolve_fused_ce_mode,
)
from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.parallel import overlap as overlap_lib
from pytorch_distributed_tpu_torch.parallel import tp as tp_lib
from pytorch_distributed_tpu_torch.parallel import zero as zero_lib
from pytorch_distributed_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pytorch_distributed_tpu_torch.train.gradsync import GradSync
from pytorch_distributed_tpu_torch.train.meters import StepMeters
from pytorch_distributed_tpu_torch.train.observe import TrainObs
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import (
    lm_params_to_jax,
    lm_state_dict_from_jax,
    momentum_state_dict,
)


class SyntheticTokenDataset:
    """Affine token process: ``x[t+1] = (a·x[t] + c) mod vocab`` with
    per-sample random (a, c, x0).  A 1-layer transformer can learn it, so
    loss visibly drops."""

    def __init__(self, length: int, seq_len: int, vocab: int, seed: int = 0):
        self.length = length
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> np.ndarray:
        # Cached: at long seq_len the per-token recurrence is real host work
        # that should run once per sample.
        cached = self._cache.get(index)
        if cached is not None:
            return cached
        rng = np.random.default_rng((self.seed, index))
        a = int(rng.integers(1, 8))
        c = int(rng.integers(0, self.vocab))
        x = np.empty(self.seq_len, np.int32)
        x[0] = int(rng.integers(0, self.vocab))
        for t in range(1, self.seq_len):
            x[t] = (a * x[t - 1] + c) % self.vocab
        self._cache[index] = x
        return x

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        return _wraparound_batch(self, step, batch_size)


def _wraparound_batch(ds, step: int, batch_size: int,
                      rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Sequential wrap-around batching shared by the LM datasets.
    ``rows=(lo, hi)``: assemble only that row range of the logical global
    batch (multi-process: each rank builds just its own shard)."""
    base = (step * batch_size) % max(1, len(ds))
    lo, hi = rows if rows is not None else (0, batch_size)
    return np.stack([ds[(base + i) % len(ds)] for i in range(lo, hi)])


class TextFileDataset:
    """Byte-level LM dataset over real files: vocab 256, sequences are
    strided windows of the concatenated bytes."""

    vocab = 256

    def __init__(self, paths, seq_len: int, stride: Optional[int] = None,
                 span=(0.0, 1.0)):
        """``span``: (start, end) fractions of the corpus, to carve held-out
        eval windows from the tail, e.g. train (0, .9) / eval (.9, 1)."""
        import glob as _glob

        if isinstance(paths, (str, bytes)):
            paths = sorted(_glob.glob(paths, recursive=True))
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        data = np.frombuffer(b"\n".join(blobs), dtype=np.uint8)
        self.data = data[int(len(data) * span[0]):int(len(data) * span[1])].copy()
        if len(self.data) < seq_len + 1:
            raise ValueError(
                f"corpus has {len(self.data)} bytes < seq_len+1 "
                f"({seq_len + 1}); add files"
            )
        self.seq_len = seq_len
        self.stride = stride or seq_len
        self.length = 1 + (len(self.data) - seq_len - 1) // self.stride

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> np.ndarray:
        lo = index * self.stride
        return self.data[lo:lo + self.seq_len].astype(np.int32)

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        return _wraparound_batch(self, step, batch_size)


def warmup_cosine_lr(base_lr: float, warmup_steps: int, total_steps: int,
                     min_frac: float = 0.1):
    """Linear warmup then cosine decay to ``min_frac·base_lr``; returns
    ``step -> lr`` for ``LMTrainer``'s ``lr_schedule``."""

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        span = max(1, total_steps - warmup_steps)
        t = min(1.0, (step - warmup_steps) / span)
        cos = 0.5 * (1.0 + np.cos(np.pi * t))
        return base_lr * (min_frac + (1.0 - min_frac) * cos)

    return schedule


def _l2_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm with f32 accumulation (the JAX ``tree_l2_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def _mesh_of(model, mesh):
    return mesh if mesh is not None else getattr(model, "mesh", None)


def _mesh_norm(model, mesh, tensors: List[torch.Tensor], names: List[str]) -> torch.Tensor:
    """The global L2 norm of ``tensors`` (one per parameter of ``names``)
    over a mesh: each element counted once, however the leaves are split.
    A leaf the mesh replicates counts on one rank of each axis it is
    replicated over, and the square sums add over every rank; without
    sharding, the local norm (synced gradients are the same everywhere)."""
    fsdp = getattr(model, "fsdp", None)
    tp = getattr(model, "tp", 1)
    if mesh is None or (tp == 1 and fsdp is None):
        return _l2_norm(tensors)
    weights = tp_lib.sq_sum_weights(names, model.specs, mesh.index("model"),
                                     [fsdp is not None and fsdp.sharded(n) for n in names],
                                     mesh.index("data"))
    sq = torch.stack([t.float().square().sum() * w for t, w in zip(tensors, weights)]).sum()
    return tp_lib.all_reduce_sum(sq, _world(mesh)).sqrt()


def _rows_norm(comm, rows: List[torch.Tensor], weights, group) -> torch.Tensor:
    """The global L2 norm of every rank's ZeRO ``rows`` (disjoint chunks):
    each leaf's chunk weighted (``tp_lib.sq_sum_weights``: a leaf the model
    group replicates counts on one of its ranks), the square sums added over
    ``group``."""
    if weights is None:
        sq = zero_lib.chunk_sq_sum(rows)
    else:
        sq = torch.stack([c.float().square().sum() * weights[i]
                          for b, row in zip(comm.buckets, rows)
                          for i, c in zip(b.index, b.lay.row_split(row))]).sum()
    return tp_lib.all_reduce_sum(sq, group).sqrt()


def _world(mesh):
    """The group of every rank of the mesh (None at world 1)."""
    return None if mesh is None else mesh.world


def lm_loss(model, tokens: torch.Tensor, fused_ce_chunks: int = 0,
            ce_mode: str = "replicated", data_group=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token ``(mean cross-entropy, accuracy)`` of ``tokens [B, L]``:
    logits at positions 0..L-2 against tokens 1..L-1; the accuracy carries
    no gradient.  ``fused_ce_chunks > 0``: the JAX fused loss path, the
    pre-head hidden states and the tied embedding, both cast to the compute
    dtype, through ``fused_ce_sums`` (``ce_mode``: its ``dp`` variant over
    ``data_group``, its ``tp`` variant over the model's tensor group) in
    that many row blocks.  Under tensor parallelism the head's logits are
    vocab-sharded: the vocab-parallel cross-entropy and argmax."""
    group = getattr(model, "tp_group", None)
    if fused_ce_chunks:
        hidden = model(tokens, return_hidden=True)
        h = hidden[:, :-1].reshape(-1, hidden.shape[-1]).to(model.dtype)
        t = tokens[:, 1:].reshape(-1)
        w = torch.ones(t.shape, dtype=torch.float32, device=t.device)
        e = model._param("embed.weight").to(model.dtype)
        if ce_mode == "tp":
            loss_sum, correct = fused_ce_sums_tp(h, e, t, w, fused_ce_chunks, model.vocab_lo,
                                                 model.vocab_size, group)
        elif ce_mode == "dp":
            loss_sum, correct = fused_ce_sums_dp(h, e, t, w, fused_ce_chunks, data_group)
        else:
            if group is not None:
                e = tp_lib.gather_param(e, model.specs["embed.weight"], group)
            loss_sum, correct = fused_ce_sums(h, e, t, w, fused_ce_chunks)
        ntok = h.shape[0]
        return loss_sum / ntok, correct / ntok
    logits = model(tokens)
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    targets = tokens[:, 1:].reshape(-1)
    if group is not None:
        loss = tp_lib.vocab_parallel_ce(flat, targets, model.vocab_lo, group).mean()
        pred = tp_lib.vocab_parallel_argmax(flat, model.vocab_lo, model.vocab_size, group)
        return loss, (pred == targets).float().mean()
    loss = cross_entropy(flat, targets)
    with torch.no_grad():
        acc = (flat.argmax(dim=-1) == targets).float().mean()
    return loss, acc


def make_lm_train_step(model, optimizer: torch.optim.Optimizer,
                       clip_grad_norm: float = 0.0, accum_steps: int = 1,
                       log_norms: bool = False, fused_ce_chunks: int = 0,
                       fused_ce_mode: str = "auto", grad_compress: Optional[str] = None,
                       zero: str = "none", overlap: str = "none",
                       bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB, mesh=None):
    """``step(tokens, lr) -> metrics``; ``tokens`` are this rank's rows of
    the global batch (all of it without a mesh).

    The JAX GSPMD step's semantics on a ``data × model`` mesh (``mesh``,
    else the model's): loss and accuracy are means over the global batch's
    tokens (each rank's mean over its equal share, averaged over the data
    group), the gradients are summed over the data group and divided by
    its size (reduce-scattered under FSDP, whose shards the model
    gathers), the global norm counts every element once, and each rank
    updates its own parameters and momentum.

    ``clip_grad_norm > 0`` rescales the gradients by ``min(1, clip /
    max(|g|, 1e-12))`` of their global L2 norm, the JAX formula (not
    ``torch.nn.utils.clip_grad_norm_``, whose epsilon differs).
    ``accum_steps > 1`` splits the batch into strided microbatches (rows j,
    j + accum, ...), sums their gradients and scales the sum by
    ``1/accum``, as the JAX step does.  ``log_norms`` adds ``grad_norm``
    (before clipping) and ``param_norm`` (after the update).
    ``fused_ce_chunks > 0`` takes the fused tied-head loss in that many row
    blocks (``fused_ce_mode``: the JAX variant rule).  ``grad_compress``,
    ``zero``, ``overlap`` and ``bucket_mb``: the gradient-communication
    stack (module docstring); ``overlap="bucketed"`` takes the explicit
    pure-DP step.  ``step.comm``
    holds its state.  Metrics are device scalars: ``loss`` and ``acc`` in
    percent.
    """
    mesh = _mesh_of(model, mesh)
    zero_mode = zero_lib.resolve_zero(zero)
    overlap_mode = overlap_lib.resolve_overlap(overlap)
    explicit = overlap_mode == "bucketed"
    dp = mesh.size("data") if mesh is not None else 1
    data_group = mesh.group("data") if mesh is not None else None
    fsdp = getattr(model, "fsdp", None)
    if explicit:
        unsupported = [
            (f"accum_steps={accum_steps}", accum_steps > 1),
            (f"fused_ce_chunks={fused_ce_chunks}", bool(fused_ce_chunks)),
            (f"zero={zero_mode!r} (use the image trainer's explicit wus "
             "path)", zero_mode != "none"),
        ]
        bad = [what for what, cond in unsupported if cond]
        if bad:
            raise ValueError(
                "the explicit-collectives LM step (overlap/"
                "explicit_collectives) supports the plain pure-DP step "
                "only; got " + "; ".join(bad))
        off_axes = {a: s for a, s in (mesh.shape.items() if mesh is not None else ())
                    if a != "data" and s > 1}
        if off_axes:
            raise ValueError(
                "the explicit-collectives LM step needs a pure data-parallel "
                f"mesh; axes {off_axes} are > 1 besides 'data'")
        if fsdp is not None:
            raise ValueError(
                "the explicit-collectives LM step keeps params replicated; "
                f"got sharded param_specs {sorted(fsdp.dims)[:3]}...")
    gc_mode, gc_cast = qcomm.resolve_mode(grad_compress, None)
    if gc_mode != "none" and not explicit:
        warnings.warn(
            f"make_lm_train_step: grad_compress={gc_mode!r} under GSPMD is "
            "a NUMERICS emulation only — the gradient psum stays f32 on the "
            "wire (XLA owns the collective). Use the explicit-collectives "
            "image path for true wire compression.",
            UserWarning, stacklevel=2)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    ce_mode = "replicated"
    if fused_ce_chunks:
        ce_mode = resolve_fused_ce_mode(fused_ce_mode, model.vocab_size, mesh,
                                        _embed_axis(model))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names = [n for n, _ in named]
    params = [p for _, p in named]
    # ZeRO over the data group; FSDP already shards the momentum (the JAX
    # momentum specs compose over the FSDP specs and shard nothing more).
    wus = zero_mode == "wus" and not explicit and fsdp is None and data_group is not None
    quantized = gc_mode in qcomm.QUANTIZED_MODES
    sharded = getattr(model, "tp", 1) > 1 or fsdp is not None
    comm = zsync = None
    if wus:
        # ZeRO's rows on an f32 wire; a quantized mode emulates on the whole
        # synced gradient first (JAX's blocks), as the GSPMD step does.
        zsync = GradSync(model, data_group, mode="none", cast_dtype=None, explicit=False,
                         zero="wus")
        comm = _WholeEmulation(model, gc_mode, zero=zsync) if quantized else zsync
    elif quantized and sharded:
        comm = _WholeEmulation(model, gc_mode)
    elif explicit or quantized:
        comm = GradSync(model, data_group, mode=gc_mode, cast_dtype=gc_cast, explicit=explicit,
                        overlap=overlap_mode, bucket_mb=bucket_mb)
    norm_weights = None
    if wus and getattr(model, "tp", 1) > 1:
        norm_weights = tp_lib.sq_sum_weights([leaf.name for leaf in zsync.leaves], model.specs,
                                             mesh.index("model"))
    count = torch.full((), float(dp), device=params[0].device)
    hyper = optimizer.param_groups[0]

    def loss_of(toks):
        with scope("lm_forward"):
            return lm_loss(model, toks, fused_ce_chunks, ce_mode, data_group)

    def step(tokens: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        if comm is not None:
            comm.arm(accum_steps == 1)
        if accum_steps == 1:
            loss, acc = loss_of(tokens)
            loss.backward()
            loss = loss.detach()
        else:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
            micro = tokens.reshape(B // accum_steps, accum_steps, -1).transpose(0, 1)
            loss = acc = 0.0
            for mb in micro:
                mb_loss, mb_acc = loss_of(mb)
                mb_loss.backward()  # .grad holds the sum over microbatches
                loss, acc = loss + mb_loss.detach(), acc + mb_acc
            inv = 1.0 / accum_steps
            for p in params:
                p.grad.mul_(inv)
            loss, acc = loss * inv, acc * inv
        loss = tp_lib.all_reduce_sum(loss, data_group) / dp
        acc = tp_lib.all_reduce_sum(acc, data_group) / dp
        for group in optimizer.param_groups:
            group["lr"] = lr
        want_norm = log_norms or clip_grad_norm > 0.0
        if wus and not quantized:
            # ZeRO: this rank's rows of the averaged gradient (a
            # reduce-scatter), their norm over the mesh, the clip, then the
            # cast, in the JAX GSPMD step's order.
            with scope("grad_sync"):
                rows = zsync.wus_rows(count)
            with scope("grad_clip"):
                gnorm = (_rows_norm(zsync, rows, norm_weights, _world(mesh)) if want_norm
                         else None)
                if clip_grad_norm > 0.0:
                    scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                    rows = [r * scale for r in rows]
            if gc_cast is not None:
                rows = [r.to(gc_cast).float() for r in rows]
        else:
            with scope("grad_sync"):
                if explicit:
                    # The JAX explicit step: the local gradient sums synced over
                    # the data axis and divided by its size, then clipped.
                    comm.sync_explicit(count)
                elif data_group is not None:
                    _sync_data([p for n, p in named if fsdp is None or not fsdp.sharded(n)],
                               data_group)
                    for p in params:
                        p.grad.div_(count)
            grads = [p.grad for p in params]
            with scope("grad_clip"):
                gnorm = _mesh_norm(model, mesh, grads, names) if want_norm else None
                if clip_grad_norm > 0.0:
                    scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                    for g in grads:
                        g.mul_(scale)
            if not explicit:
                # The JAX GSPMD step: the emulation on the clipped gradient.
                if quantized:
                    comm.emulate_grads()
                elif gc_cast is not None:
                    for p in params:
                        p.grad = p.grad.to(gc_cast).float()
            rows = zsync.grad_rows() if wus else None
        with scope("optimizer"):
            if wus:
                # The momentum lives in the rows: the SGD on them, all-gather.
                zsync.wus_update(rows, lr, hyper["momentum"], hyper["weight_decay"])
            else:
                optimizer.step()
        metrics = {"loss": loss, "acc": acc * 100.0}
        if log_norms:
            metrics["grad_norm"] = gnorm
            with torch.no_grad():
                metrics["param_norm"] = _mesh_norm(model, mesh, params, names)
        return metrics

    step.comm = comm
    return step


class _WholeEmulation:
    """The GSPMD emulation of a sharded model (tensor parallelism, FSDP) and
    of any model under ``--zero wus``: JAX fake-quantizes each global leaf
    in blocks of its own flat JAX layout, so every rank gathers each
    averaged gradient whole, runs the emulation on the whole leaves with a
    whole residual (the same on every rank) and keeps its part.  The ``GradSync`` face the trainer and the
    checkpoints use: ``emulate_grads``, ``checkpoint_trees``, ``load``.
    ``zero``: under ``--zero wus``, the ``GradSync`` whose rows hold the
    momentum (saved and loaded with the residual)."""

    explicit = False
    full_residual = True

    def __init__(self, model, mode: str, block: int = qcomm.DEFAULT_BLOCK,
                 zero: Optional[GradSync] = None):
        from pytorch_distributed_tpu_torch.utils.convert import jax_leaves

        self.zero, self.wus = zero, zero is not None
        self.buckets = zero.buckets if zero is not None else ()
        self.model, self.mode = model, mode
        self.leaves = jax_leaves(model)
        named = dict(model.named_parameters())
        self.params = [named[leaf.name] for leaf in self.leaves]
        self.shapes = [tuple(leaf.to_jax(torch.empty(self._full_shape(leaf.name, p),
                                                     device="meta")).shape)
                       for leaf, p in zip(self.leaves, self.params)]
        self.lay = qcomm.PackedLayout([int(np.prod(s)) for s in self.shapes], 1, block)
        self.residual = torch.zeros(self.lay.numel, device=self.params[0].device)

    def _full_shape(self, name: str, p: torch.Tensor) -> Tuple[int, ...]:
        shape = list(p.shape)
        fsdp, split = self.model.fsdp, self.model.specs.get(name)
        if fsdp is not None and fsdp.sharded(name):
            shape[fsdp.dims[name]] *= fsdp.n
        if split is not None:
            shape[split.dim] = split.full
        return tuple(shape)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        fsdp = self.model.fsdp
        if fsdp is not None and fsdp.sharded(name):
            t = fsdp.gather({name: t})[name]
        return tp_lib.gather_tensor(t, self.model.specs.get(name), self.model.tp_group)

    def arm(self, on: bool) -> None:
        pass

    @torch.no_grad()
    def emulate_grads(self) -> None:
        whole = [leaf.to_jax(self._whole(leaf.name, p.grad))
                 for leaf, p in zip(self.leaves, self.params)]
        out, self.residual = qcomm.emulate(self.lay, self.lay.pack(whole, self.residual.device),
                                           self.residual, self.mode)
        model = self.model
        for leaf, p, v in zip(self.leaves, self.params, self.lay.unpack(out, self.shapes)):
            t = tp_lib.shard_tensor(leaf.from_jax(v), model.specs.get(leaf.name), model.tp_rank)
            if model.fsdp is not None:
                t = model.fsdp.shard({leaf.name: t})[leaf.name]
            p.grad.copy_(t)

    def checkpoint_trees(self) -> Dict[str, Optional[dict]]:
        from pytorch_distributed_tpu_torch.utils.convert import tree_from_leaves

        momentum = self.zero.checkpoint_trees()["momentum"] if self.zero is not None else None
        return {"momentum": momentum, "residual": tree_from_leaves(
            [leaf.path for leaf in self.leaves],
            [v.detach().cpu().numpy().copy() for v in self.lay.unpack(self.residual,
                                                                      self.shapes)])}

    def load(self, momentum, residual) -> None:
        """The whole residual of a checkpoint when its shapes are this
        model's, else zeros (JAX resets error feedback on a mode switch);
        the momentum into ``zero``'s rows."""
        from pytorch_distributed_tpu_torch.utils.convert import tree_at

        if self.zero is not None:
            self.zero.load(momentum, None)
        saved = None
        if residual:
            try:
                saved = [np.asarray(tree_at(residual, leaf.path), np.float32)
                         for leaf in self.leaves]
            except (KeyError, TypeError):
                saved = None
            if saved is not None and [a.shape for a in saved] != self.shapes:
                saved = None
        self.residual = (torch.zeros_like(self.residual) if saved is None else
                         self.lay.pack([torch.from_numpy(a) for a in saved],
                                       self.residual.device))


def _sync_data(params: List[torch.Tensor], group) -> None:
    """Sum the ``.grad`` of ``params`` over the data group, in place, in one
    flat f32 all-reduce."""
    if group is None or not params:
        return
    summed = qcomm.sum_finish(qcomm.sum_start([p.grad for p in params], group),
                              [p.shape for p in params])
    for p, g in zip(params, summed):
        p.grad.copy_(g)


def _embed_axis(model) -> Optional[str]:
    """The mesh axis the tied embedding's vocab rows are split over (its
    ``embed`` spec's first entry): ``model`` under tensor parallelism,
    ``data`` where FSDP shards that dimension, else None."""
    if getattr(model, "tp", 1) > 1:
        return "model"
    fsdp = getattr(model, "fsdp", None)
    if fsdp is not None and fsdp.dims.get("embed.weight") == 0:
        return "data"
    return None


def make_lm_eval_step(model, mesh=None):
    """``step(tokens) -> {"loss_sum", "correct", "count"}``: exact
    token-weighted sums of the held-out loss and next-token hits over the
    global batch (each rank's rows, summed over the data group), so the
    host aggregates them exactly."""
    mesh = _mesh_of(model, mesh)
    data_group = mesh.group("data") if mesh is not None else None
    group = getattr(model, "tp_group", None)

    @torch.no_grad()
    def step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = model(tokens)
        flat = logits[:, :-1].reshape(-1, logits.shape[-1])
        targets = tokens[:, 1:].reshape(-1)
        if group is not None:
            loss_sum = tp_lib.vocab_parallel_ce(flat, targets, model.vocab_lo, group).sum()
            pred = tp_lib.vocab_parallel_argmax(flat, model.vocab_lo, model.vocab_size, group)
        else:
            loss_sum = cross_entropy(flat, targets) * float(targets.numel())
            pred = flat.argmax(dim=-1)
        sums = torch.stack([loss_sum, (pred == targets).float().sum(),
                            torch.full((), float(targets.numel()), device=flat.device)])
        loss_sum, correct, count = tp_lib.all_reduce_sum(sums, data_group).unbind(0)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    return step


class LMTrainer:
    """Step-driven LM training on one device: meters, periodic display, a
    held-out eval loop (loss / perplexity / next-token accuracy) with best
    tracking.

    ``model`` comes initialised (its weights are the f32 master copy);
    ``lr_schedule`` is an optional ``step -> lr`` callable (e.g.
    ``warmup_cosine_lr``) overriding the fixed ``lr``; ``fused_ce_chunks``
    and ``fused_ce_mode`` go to the train step (eval keeps the logits head,
    as the JAX eval step does).  ``step_times`` and
    ``losses`` collect every step's host seconds as the meters measure
    them and its loss (a device scalar).

    ``grad_compress``, ``zero``, ``overlap`` and ``bucket_mb`` go to the
    train step (the gradient-communication stack); its residual is saved
    and restored with the checkpoints.

    ``metrics_jsonl``, ``hb_dir``, ``hb_interval_s``, ``mfu``, ``goodput``
    and ``step_attr``: the metrics stream (``train/observe.py``), as the
    JAX ``LMTrainer`` takes them; ``obs`` is its ``MetricsLogger``.

    ``checkpoint_dir``: checkpoint every ``save_steps`` steps (0: only at the
    end of ``fit``) there.  ``resume``: a checkpoint file to restore the
    weights, the momentum and the step from; ``fit`` continues at
    ``max(global_step, step)`` of its ``ft`` record, on the same tokens and
    learning rates as an uninterrupted run (the batching is step-indexed).
    """

    def __init__(self, model, dataset, batch_size: int, lr: float = 1e-2,
                 eval_dataset=None, eval_every: int = 0, eval_batches: int = 8,
                 lr_schedule=None, clip_grad_norm: float = 0.0,
                 accum_steps: int = 1, fused_ce_chunks: int = 0,
                 fused_ce_mode: str = "auto", momentum: float = 0.9,
                 weight_decay: float = 1e-4, checkpoint_dir: Optional[str] = None,
                 save_steps: int = 0, resume: Optional[str] = None,
                 grad_compress: Optional[str] = None, zero: Optional[str] = None,
                 overlap: str = "none", bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB,
                 mesh=None, metrics_jsonl: Optional[str] = None, hb_dir: Optional[str] = None,
                 hb_interval_s: float = 5.0, mfu: bool = False, goodput: bool = False,
                 step_attr: bool = False):
        self.model = model
        self.mesh = _mesh_of(model, mesh)
        self.is_primary = self.mesh is None or self.mesh.is_primary
        self.dataset = dataset
        self.batch_size = batch_size
        self.lr = lr
        self.lr_schedule = lr_schedule
        self.optimizer = sgd(model.parameters(), lr, momentum, weight_decay)
        self.step_fn = make_lm_train_step(model, self.optimizer,
                                          clip_grad_norm=clip_grad_norm,
                                          accum_steps=accum_steps,
                                          log_norms=bool(metrics_jsonl),
                                          fused_ce_chunks=fused_ce_chunks,
                                          fused_ce_mode=fused_ce_mode,
                                          grad_compress=grad_compress,
                                          zero=zero_lib.resolve_zero(zero), overlap=overlap,
                                          bucket_mb=bucket_mb, mesh=self.mesh)
        self.comm = self.step_fn.comm
        mesh_ = self.mesh
        self.ro = TrainObs(
            model.device, mesh_.rank if mesh_ is not None else 0,
            int(np.prod(mesh_.sizes)) if mesh_ is not None else 1,
            metrics_jsonl=metrics_jsonl, hb_dir=hb_dir, hb_interval_s=hb_interval_s,
            hb_world=mesh_.size("data") if mesh_ is not None else 1, mfu=mfu,
            goodput=goodput, step_attr=step_attr,
            cost=lambda: lm_step_cost_for(model, batch_size, dataset.seq_len,
                                          fused_ce_chunks=fused_ce_chunks))
        self.obs = self.ro.obs
        self.eval_dataset = eval_dataset
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self._eval_fn = (make_lm_eval_step(model, self.mesh) if eval_dataset is not None
                         else None)
        self._span = None
        self.best_ppl = float("inf")
        self.eval_history: list = []  # (loss, ppl, acc%) per evaluate() call
        self.step_times: list = []
        self.losses: list = []
        self.checkpoint_dir = checkpoint_dir
        self.save_steps = save_steps
        self._start_step = 0
        if resume:
            _, meta = load_checkpoint(resume, model, self.optimizer, comm=self.comm)
            ft = meta["ft"]
            self._start_step = max(int(ft["global_step"]), int(ft["step"]))
            if self._eval_fn is not None and float(meta["best_acc1"]) > 0:
                self.best_ppl = float(meta["best_acc1"])
            print(f"=> resumed {meta['arch']} from '{resume}' at step {self._start_step}",
                  flush=True)

    def _save_checkpoint(self, completed: int, is_best: bool = False) -> None:
        """The best perplexity rides in the ``best_acc1`` slot; the LM is
        epochless, so step == global step restores the exact token stream.
        Every rank calls it (a sharded model's trees are gathered by
        collectives); rank 0 writes."""
        trees = self._checkpoint_trees()
        if not self.is_primary:
            return
        save_checkpoint(self.checkpoint_dir, self.model, self.optimizer, completed, 0,
                        "transformer_lm", self.best_ppl if self._eval_fn is not None else 0.0,
                        is_best=is_best, ft={"step": completed, "global_step": completed},
                        **trees)

    def _checkpoint_trees(self) -> Dict[str, Optional[dict]]:
        """The JAX-layout trees this run saves beyond the model's own: the
        gradient stack's momentum and residual and, for a sharded model, the
        whole parameters and momentum gathered from every rank."""
        trees = self.comm.checkpoint_trees() if self.comm is not None else {}
        model = self.model
        if getattr(model, "tp", 1) == 1 and getattr(model, "fsdp", None) is None:
            return trees
        dev = model.device

        def whole(local: Dict[str, torch.Tensor]) -> dict:
            if model.fsdp is not None:
                local = model.fsdp.gather(local)
            return lm_params_to_jax(tp_lib.gather_state(local, model.specs, model.tp_group))

        if trees.get("momentum") is not None:   # the ZeRO rows, gathered over data
            trees["momentum"] = whole(lm_state_dict_from_jax(trees["momentum"], device=dev))
        else:
            trees["momentum"] = whole(momentum_state_dict(model, self.optimizer))
        if (trees.get("residual") is not None and not self.comm.explicit
                and not getattr(self.comm, "full_residual", False)):
            trees["residual"] = whole(lm_state_dict_from_jax(trees["residual"], device=dev))
        trees["params"] = whole(dict(model.state_dict()))
        return trees

    def _row_span(self) -> Tuple[int, int]:
        """This rank's row range of the global batch: the contiguous slice of
        its data index (the whole batch for every rank of a model group,
        which shares it)."""
        if self._span is None:
            B = self.batch_size
            dp = self.mesh.size("data") if self.mesh is not None else 1
            if B % dp:
                raise ValueError(
                    "One of device_put args was given the sharding of NamedSharding(mesh="
                    f"Mesh({', '.join(f'{a!r}: {n}' for a, n in self.mesh.shape.items())}, "
                    f"axis_types=({', '.join(['Auto'] * len(self.mesh.axes))})), "
                    "spec=PartitionSpec('data', None), memory_kind=device), which implies "
                    "that the global size of its dimension 0 should be divisible by "
                    f"{dp}, but it is equal to {B} (full shape: ({B}, "
                    f"{self.dataset.seq_len}))")
            d = self.mesh.index("data") if self.mesh is not None else 0
            self._span = (d * B // dp, (d + 1) * B // dp)
        return self._span

    def _local_rows(self, global_batch: np.ndarray) -> np.ndarray:
        """Slice an already-assembled global batch down to this rank's rows
        (prefer ``_local_batch``, which never assembles foreign rows)."""
        lo, hi = self._row_span()
        return global_batch[lo:hi]

    def _local_batch(self, ds, step: int) -> np.ndarray:
        """Assemble only this rank's rows of logical global batch ``step``."""
        return _wraparound_batch(ds, step, self.batch_size, rows=self._row_span())

    def _tokens(self, ds, step: int) -> torch.Tensor:
        return torch.from_numpy(self._local_batch(ds, step)).to(self.model.device)

    def evaluate(self) -> Tuple[float, float, float]:
        """Held-out ``(loss, perplexity, next-token acc%)`` over
        ``eval_batches`` batches; prints the summary line."""
        if self._eval_fn is None:
            raise ValueError("LMTrainer built without eval_dataset")
        totals = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for i in range(self.eval_batches):
            sums = self._eval_fn(self._tokens(self.eval_dataset, i))
            for k in totals:
                totals[k] += float(sums[k])
        count = max(totals["count"], 1.0)
        loss = totals["loss_sum"] / count
        ppl = float(np.exp(min(loss, 30.0)))
        acc = totals["correct"] * 100.0 / count
        print(f" * Eval loss {loss:.4f} ppl {ppl:.2f} Acc@1 {acc:.2f}", flush=True)
        self.eval_history.append((loss, ppl, acc))
        return loss, ppl, acc

    def fit(self, steps: int, print_freq: int = 10) -> float:
        """Train up to step ``steps`` (from the resumed step, else 0);
        returns the last step's loss.  The metrics stream closes at the
        end of the steps (before the final eval), as in the JAX trainer."""
        meters = StepMeters(
            steps,
            [("loss", "Loss", ":.4e"), ("acc", "Acc@1", ":6.2f")],
            prefix="Step: ",
        )
        final_ppl = None  # ppl from an interval eval on the very last step
        completed = start = min(self._start_step, steps)
        tokens_per_step = self.batch_size * self.dataset.seq_len
        ro = self.ro
        meters.restart_clock()
        try:
            for i in range(start, steps):
                with ro.data_wait():
                    tokens = self._tokens(self.dataset, i)
                lr = self.lr_schedule(i) if self.lr_schedule is not None else self.lr
                with scope("lm_step"), ro.device_window():
                    metrics = self.step_fn(tokens, lr)
                with ro.host_sync():
                    dt = meters.update(metrics, self.batch_size)
                self.step_times.append(dt)
                self.losses.append(metrics["loss"])
                ro.log_step(i, dt, tokens_per_step, lr, dict(metrics))
                meters.maybe_display(i, print_freq)
                completed = i + 1
                if (self.checkpoint_dir and self.save_steps > 0
                        and completed % self.save_steps == 0):
                    self._save_checkpoint(completed)
                    meters.restart_clock()  # exclude checkpoint I/O from the meter
                if (self._eval_fn is not None and self.eval_every > 0
                        and (i + 1) % self.eval_every == 0):
                    _, final_ppl, _ = self.evaluate()
                    self.best_ppl = min(self.best_ppl, final_ppl)
                    meters.restart_clock()  # eval must not pollute the meter
                else:
                    final_ppl = None
        finally:
            ro.close(completed - 1)
        is_best = False
        if self._eval_fn is not None:
            if final_ppl is None:  # the last step did not land on an eval
                _, final_ppl, _ = self.evaluate()
            # <= so the final state is marked best when it ties the best
            # seen (an interval eval on the last step set best_ppl).
            is_best = final_ppl <= self.best_ppl
            self.best_ppl = min(self.best_ppl, final_ppl)
        if self.checkpoint_dir:
            self._save_checkpoint(completed, is_best=is_best)
        return meters["loss"].val
