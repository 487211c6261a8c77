"""Language-model pretraining on one device, the port of
``pytorch_distributed_tpu/train/lm.py``.

- ``SyntheticTokenDataset`` (a learnable affine token process, the LM smoke
  oracle), ``TextFileDataset`` (byte-level LM over files), the step-indexed
  wrap-around batching and ``warmup_cosine_lr``: copies of the JAX module's,
  numpy in and out, so both packages see the same tokens.
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

The gradient-communication stack (``train/gradsync.py``), as the JAX LM
step runs it on one device: ``grad_compress`` ``bf16`` / ``int8`` / ``fp8``
is the numerics emulation on the (clipped) gradient, with a param-shaped
error-feedback residual; ``overlap="bucketed"`` takes the port of the JAX explicit step, the
gradient synced per bucket by the local one-rank collectives (quantized
twice under int8/fp8, the residual stacked ``(1, *shape)``) and clipped
after; ``zero="wus"`` shards the momentum over a data axis of one, which
changes nothing, as in JAX at world 1.  The residual rides in checkpoints.

Not ported yet (ROADMAP.md queue A): data parallelism across ranks for the
LM (A21), meshes and every parallel layout (the fused CE head's ``dp`` and
``tp`` variants with them), the observability and fault-tolerance layers,
elastic membership and the background feeder thread.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_ce_sums, resolve_fused_ce_mode
from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.parallel import overlap as overlap_lib
from pytorch_distributed_tpu_torch.parallel import zero as zero_lib
from pytorch_distributed_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pytorch_distributed_tpu_torch.train.gradsync import GradSync
from pytorch_distributed_tpu_torch.train.meters import StepMeters
from pytorch_distributed_tpu_torch.train.optim import sgd


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


def _wraparound_batch(ds, step: int, batch_size: int) -> np.ndarray:
    """Sequential wrap-around batching shared by the LM datasets."""
    base = (step * batch_size) % max(1, len(ds))
    return np.stack([ds[(base + i) % len(ds)] for i in range(batch_size)])


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


def lm_loss(model, tokens: torch.Tensor, fused_ce_chunks: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token ``(mean cross-entropy, accuracy)`` of ``tokens [B, L]``:
    logits at positions 0..L-2 against tokens 1..L-1; the accuracy carries
    no gradient.  ``fused_ce_chunks > 0``: the JAX fused loss path, the
    pre-head hidden states and the tied embedding, both cast to the compute
    dtype, through ``fused_ce_sums`` in that many row blocks."""
    if fused_ce_chunks:
        hidden = model(tokens, return_hidden=True)
        h = hidden[:, :-1].reshape(-1, hidden.shape[-1]).to(model.dtype)
        t = tokens[:, 1:].reshape(-1)
        w = torch.ones(t.shape, dtype=torch.float32, device=t.device)
        e = model.embed.weight.to(model.dtype)
        loss_sum, correct = fused_ce_sums(h, e, t, w, fused_ce_chunks)
        ntok = h.shape[0]
        return loss_sum / ntok, correct / ntok
    logits = model(tokens)
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    targets = tokens[:, 1:].reshape(-1)
    loss = cross_entropy(flat, targets)
    with torch.no_grad():
        acc = (flat.argmax(dim=-1) == targets).float().mean()
    return loss, acc


def make_lm_train_step(model, optimizer: torch.optim.Optimizer,
                       clip_grad_norm: float = 0.0, accum_steps: int = 1,
                       log_norms: bool = False, fused_ce_chunks: int = 0,
                       fused_ce_mode: str = "auto", grad_compress: Optional[str] = None,
                       zero: str = "none", overlap: str = "none",
                       bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB):
    """``step(tokens [B, L], lr) -> metrics`` for one device.

    ``clip_grad_norm > 0`` rescales the gradients by ``min(1, clip /
    max(|g|, 1e-12))`` of their global L2 norm, the JAX formula (not
    ``torch.nn.utils.clip_grad_norm_``, whose epsilon differs).
    ``accum_steps > 1`` splits the batch into strided microbatches (rows j,
    j + accum, ...), sums their gradients and scales the sum by
    ``1/accum``, as the JAX step does.  ``log_norms`` adds ``grad_norm``
    (before clipping) and ``param_norm`` (after the update).
    ``fused_ce_chunks > 0`` takes the fused tied-head loss in that many row
    blocks (``fused_ce_mode``: the JAX variant rule, ``replicated`` on one
    device).  ``grad_compress``, ``zero``, ``overlap`` and ``bucket_mb``:
    the gradient-communication stack (module docstring); ``step.comm``
    holds its state.  Metrics are device scalars:
    ``loss`` and ``acc`` in percent.
    """
    zero_mode = zero_lib.resolve_zero(zero)
    overlap_mode = overlap_lib.resolve_overlap(overlap)
    explicit = overlap_mode == "bucketed"
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
    if fused_ce_chunks:
        resolve_fused_ce_mode(fused_ce_mode, model.embed.num_embeddings)
    params = [p for p in model.parameters() if p.requires_grad]
    comm = None
    if explicit or gc_mode in qcomm.QUANTIZED_MODES:
        comm = GradSync(model, None, mode=gc_mode, cast_dtype=gc_cast, explicit=explicit,
                        overlap=overlap_mode, bucket_mb=bucket_mb)
    one = torch.ones((), device=params[0].device)

    def step(tokens: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, acc = lm_loss(model, tokens, fused_ce_chunks)
            loss.backward()
            loss = loss.detach()
        else:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
            micro = tokens.reshape(B // accum_steps, accum_steps, -1).transpose(0, 1)
            loss = acc = 0.0
            for mb in micro:
                mb_loss, mb_acc = lm_loss(model, mb, fused_ce_chunks)
                mb_loss.backward()  # .grad holds the sum over microbatches
                loss, acc = loss + mb_loss.detach(), acc + mb_acc
            inv = 1.0 / accum_steps
            for p in params:
                p.grad.mul_(inv)
            loss, acc = loss * inv, acc * inv
        if explicit:
            # The JAX explicit step: the gradient synced over the data axis
            # (one rank) and divided by its size, then clipped.
            comm.sync_explicit(one)
        grads = [p.grad for p in params]
        gnorm = _l2_norm(grads) if (log_norms or clip_grad_norm > 0.0) else None
        if clip_grad_norm > 0.0:
            scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)
        if not explicit:
            # The JAX GSPMD step: the emulation on the clipped gradient.
            if comm is not None:
                comm.emulate_grads()
            elif gc_cast is not None:
                for p in params:
                    p.grad = p.grad.to(gc_cast).float()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        metrics = {"loss": loss, "acc": acc * 100.0}
        if log_norms:
            metrics["grad_norm"] = gnorm
            with torch.no_grad():
                metrics["param_norm"] = _l2_norm(params)
        return metrics

    step.comm = comm
    return step


def make_lm_eval_step(model):
    """``step(tokens [B, L]) -> {"loss_sum", "correct", "count"}``: exact
    token-weighted sums of the held-out loss and next-token hits, so the
    host aggregates them exactly."""

    @torch.no_grad()
    def step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = model(tokens)
        flat = logits[:, :-1].reshape(-1, logits.shape[-1])
        targets = tokens[:, 1:].reshape(-1)
        count = float(targets.numel())
        correct = (flat.argmax(dim=-1) == targets).float().sum()
        return {"loss_sum": cross_entropy(flat, targets) * count,
                "correct": correct, "count": count}

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
                 overlap: str = "none", bucket_mb: float = overlap_lib.DEFAULT_BUCKET_MB):
        self.model = model
        self.dataset = dataset
        self.batch_size = batch_size
        self.lr = lr
        self.lr_schedule = lr_schedule
        self.optimizer = sgd(model.parameters(), lr, momentum, weight_decay)
        self.step_fn = make_lm_train_step(model, self.optimizer,
                                          clip_grad_norm=clip_grad_norm,
                                          accum_steps=accum_steps,
                                          fused_ce_chunks=fused_ce_chunks,
                                          fused_ce_mode=fused_ce_mode,
                                          grad_compress=grad_compress,
                                          zero=zero_lib.resolve_zero(zero), overlap=overlap,
                                          bucket_mb=bucket_mb)
        self.comm = self.step_fn.comm
        self.eval_dataset = eval_dataset
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self._eval_fn = make_lm_eval_step(model) if eval_dataset is not None else None
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
        epochless, so step == global step restores the exact token stream."""
        trees = self.comm.checkpoint_trees() if self.comm is not None else {}
        save_checkpoint(self.checkpoint_dir, self.model, self.optimizer, completed, 0,
                        "transformer_lm", self.best_ppl if self._eval_fn is not None else 0.0,
                        is_best=is_best, ft={"step": completed, "global_step": completed},
                        **trees)

    def _tokens(self, ds, step: int) -> torch.Tensor:
        return torch.from_numpy(ds.batch(step, self.batch_size)).to(self.model.device)

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
        returns the last step's loss."""
        meters = StepMeters(
            steps,
            [("loss", "Loss", ":.4e"), ("acc", "Acc@1", ":6.2f")],
            prefix="Step: ",
        )
        final_ppl = None  # ppl from an interval eval on the very last step
        completed = start = min(self._start_step, steps)
        meters.restart_clock()
        for i in range(start, steps):
            tokens = self._tokens(self.dataset, i)
            lr = self.lr_schedule(i) if self.lr_schedule is not None else self.lr
            metrics = self.step_fn(tokens, lr)
            self.step_times.append(meters.update(metrics, self.batch_size))
            self.losses.append(metrics["loss"])
            meters.maybe_display(i, print_freq)
            completed = i + 1
            if self.checkpoint_dir and self.save_steps > 0 and completed % self.save_steps == 0:
                self._save_checkpoint(completed)
                meters.restart_clock()  # exclude checkpoint I/O from the meter
            if (self._eval_fn is not None and self.eval_every > 0
                    and (i + 1) % self.eval_every == 0):
                _, final_ppl, _ = self.evaluate()
                self.best_ppl = min(self.best_ppl, final_ppl)
                meters.restart_clock()  # eval must not pollute the meter
            else:
                final_ppl = None
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
