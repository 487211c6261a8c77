"""Divergence guard: the host-side skip/rollback policy over the train
step's non-finite flag, and the last-known-good state snapshot — the port
of ``pytorch_distributed_tpu/ft/divergence.py``.

Division of labor, as in the JAX package:

- **Inside the step** (``guard_nonfinite=True`` on ``train/steps.py``'s
  ``make_train_step`` and ``train/lm.py``'s ``make_lm_train_step``): a
  ``nonfinite`` flag is computed on the device from the loss and the
  global gradient norm, and the parameter / momentum / BN-buffer /
  ``GradSync`` update is gated with ``torch.where`` — a bad batch's update
  is skipped before the host ever hears about it.
- **Host side** (this module): ``DivergenceGuard`` buffers the flags as
  unconverted device tensors and drains them in one host transfer every
  ``check_every`` observations, so the loop never synchronizes per step.
  Every flagged step is recorded as a ``skip`` ft_event; K *consecutive*
  flagged steps mean skipping is not working (the state itself is
  corrupt) and the guard asks the trainer to roll back to the last-good
  snapshot with an LR backoff.

``StateKeeper`` holds that snapshot in host memory: the model's parameters
and buffers (BatchNorm statistics included), the optimizer's momentum, every
``GradSync`` state tensor (error-feedback residuals, ZeRO rows) and the
step's counter.  Each rank keeps its own shards, so every rank must call
``update`` at the same cadence (the trainers refresh it at each
``save_steps`` boundary); ``restore`` copies the snapshot back in place on
the model's device.

No torch at import time: the fleet's torch-free processes import ``ft``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


def _host_values(flags: List[Any]) -> List[float]:
    """The flags as floats, in one host transfer when they are tensors on
    one device (one ``.tolist()`` of their stack), else one by one."""
    if flags and all(hasattr(f, "device") and hasattr(f, "reshape") for f in flags) \
            and len({str(f.device) for f in flags}) == 1:
        import torch

        return torch.stack([f.reshape(()).float() for f in flags]).tolist()
    return [float(f) for f in flags]


class DivergenceGuard:
    """Skip-and-rollback policy over the step's ``nonfinite`` flag.

    >>> guard = DivergenceGuard(rollback_k=3, check_every=10, obs=logger)
    >>> ...
    >>> if guard.observe(step, metrics.get("nonfinite")):
    ...     keeper.restore(model, optimizer, comm)   # trainer-side rollback
    ...     guard.note_rollback(step, keeper.step)

    ``observe`` returns True when a rollback is due (decided at drain
    cadence, so up to ``check_every - 1`` steps late — the price of never
    synchronizing per step; the in-step gate has already kept those steps
    out of the weights).
    """

    def __init__(self, rollback_k: int = 3, check_every: int = 10,
                 lr_backoff: float = 0.5, obs=None):
        if rollback_k < 1:
            raise ValueError(f"rollback_k must be >= 1, got {rollback_k}")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1], got {lr_backoff}")
        self.rollback_k = int(rollback_k)
        self.check_every = max(1, int(check_every))
        self.lr_backoff = float(lr_backoff)
        self.obs = obs
        self.lr_scale = 1.0
        self.consecutive = 0
        self.rollbacks = 0
        self.skipped: List[int] = []      # steps whose update was gated off
        self._pending: List[Tuple[int, Any]] = []  # unconverted flags

    def observe(self, step: int, flag) -> bool:
        """Buffer one step's (possibly unfinished device) flag; drains every
        ``check_every`` observations.  Returns True when the drain decided
        a rollback is needed."""
        if flag is None:
            return False
        self._pending.append((int(step), flag))
        if len(self._pending) >= self.check_every:
            return self.drain()
        return False

    def drain(self) -> bool:
        """Convert the buffered flags (the one host transfer) and apply the
        policy.  Idempotent when the buffer is empty."""
        if not self._pending:
            return False
        pending, self._pending = self._pending, []
        rollback = False
        for (step, _), value in zip(pending, _host_values([f for _, f in pending])):
            if not value > 0.0:
                self.consecutive = 0
                continue
            self.consecutive += 1
            self.skipped.append(step)
            self._emit("skip", step=step, consecutive=self.consecutive)
            if self.consecutive >= self.rollback_k:
                rollback = True
        return rollback

    def note_rollback(self, step: int, restored_step: Optional[int]) -> float:
        """Record a completed rollback: backs off the LR scale, resets the
        consecutive counter, emits the ft_event.  Returns the new scale."""
        self.lr_scale *= self.lr_backoff
        self.consecutive = 0
        self.rollbacks += 1
        self._emit("rollback", step=int(step),
                   restored_step=(int(restored_step)
                                  if restored_step is not None else -1),
                   lr_scale=self.lr_scale)
        return self.lr_scale

    def _emit(self, kind: str, **fields) -> None:
        if self.obs is not None and hasattr(self.obs, "log_event"):
            self.obs.log_event(kind, **fields)


def _state_tensors(model, optimizer, comm) -> List[Any]:
    """The tensors of a train state, in a fixed order: the model's
    parameters and buffers, one momentum buffer per parameter (None before
    the optimizer's first step) and the ``GradSync`` state."""
    params = list(model.parameters())
    out = [p.data for p in params] + list(model.buffers())
    if optimizer is not None:
        out += [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
    if comm is not None:
        out += list(comm.state_tensors())
    return out


class StateKeeper:
    """Host-memory snapshot of the last-known-good train state: the
    rollback source, with no filesystem round trip.  Every rank snapshots
    its own tensors (its shards under FSDP, tensor parallelism or ZeRO), so
    every rank must call ``update`` at the same step."""

    def __init__(self):
        self._host: Optional[List[Any]] = None
        self._count: Optional[int] = None
        self.step: Optional[int] = None

    @property
    def has_snapshot(self) -> bool:
        return self._host is not None

    def update(self, model, optimizer, step: int, comm=None, step_fn=None) -> None:
        """Snapshot ``model``, ``optimizer``'s momentum and ``comm``'s state
        (and ``step_fn.count``, the dropout masks' step) as of ``step``
        completed steps.  The host buffers are allocated once (pinned when
        the tensors are on a card) and overwritten in place."""
        import torch

        tensors = _state_tensors(model, optimizer, comm)
        if self._host is None or len(self._host) != len(tensors) or any(
                (h is None) != (t is None) or (t is not None and h.shape != t.shape)
                for h, t in zip(self._host, tensors)):
            self._host = [None if t is None else
                          torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                      pin_memory=t.is_cuda)
                          for t in tensors]
        with torch.no_grad():
            for h, t in zip(self._host, tensors):
                if t is not None:
                    h.copy_(t)
        self._count = getattr(step_fn, "count", None)
        self.step = int(step)

    def restore(self, model, optimizer, comm=None, step_fn=None) -> None:
        """Copy the snapshot back in place on the model's device.  A
        momentum buffer the snapshot predates restarts from zeros (the
        JAX package's zero-initialized momentum: ``mu * 0 + g`` is ``g``)."""
        if self._host is None:
            raise RuntimeError(
                "StateKeeper has no snapshot to restore (update() never "
                "called)")
        import torch

        tensors = _state_tensors(model, optimizer, comm)
        params = list(model.parameters())
        n_model = len(params) + len(list(model.buffers()))
        n_mom = len(params) if optimizer is not None else 0
        with torch.no_grad():
            for k, (h, t) in enumerate(zip(self._host, tensors)):
                if n_model <= k < n_model + n_mom:
                    p = params[k - n_model]
                    if h is None:
                        if t is not None:
                            t.zero_()
                        continue
                    if t is None:
                        optimizer.state.setdefault(p, {})["momentum_buffer"] = (
                            h.to(p.device, copy=True))
                        continue
                if t is not None and h is not None:
                    t.copy_(h)
        if step_fn is not None and self._count is not None:
            step_fn.count = self._count
