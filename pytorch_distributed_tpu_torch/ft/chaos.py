"""Deterministic, seedable fault injectors: the port of
``pytorch_distributed_tpu/ft/chaos.py``.

Every injector is a pure function of ``(seed, step)``: two runs with the
same schedule inject the same faults at the same steps, so the survival
tests are reproducible and a failing chaos run can be replayed.  Injectors
hook into the trainers through the ``chaos=`` parameter (``Trainer`` and
``LMTrainer``), which calls

- ``on_step(trainer, step)``   once per loop iteration, before the batch —
  signal/kill/delay/lr faults;
- ``on_batch(step, batch)``    on the device batch, inside the ``data_wait``
  window — data corruption (NaN poisoning for float inputs);
- ``on_collective(trainer, step)``  inside the recorded collective region,
  between the flight recorder's ``coll_enter`` and the step call —
  stalled-rank faults the hang watchdog must catch (``HangAt``).

File-level corruption (``corrupt_file``) is trainer-independent; it backs
the checkpoint-integrity tests.  A rank is ``torch.distributed.get_rank()``
when a process group is up, else 0.  torch is imported lazily (inside the
hooks that need it).
"""

from __future__ import annotations

import os
import signal as _signal
import time
from typing import Dict, Iterable, Optional, Sequence


def _rank() -> int:
    """This process's rank in the default group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class ChaosInjector:
    """Base injector: no-op hooks, subclasses override what they need."""

    def on_step(self, trainer, step: int) -> None:  # noqa: ARG002
        return None

    def on_batch(self, step: int, batch):  # noqa: ARG002
        return batch

    def on_collective(self, trainer, step: int) -> None:  # noqa: ARG002
        return None


class SignalAt(ChaosInjector):
    """Deliver ``signum`` to this process when the loop reaches ``at_step``
    — the deterministic stand-in for a preemption notice (SIGTERM at step
    k) or an interactive Ctrl-C (SIGINT)."""

    def __init__(self, at_step: int, signum: int = _signal.SIGTERM,
                 pid: Optional[int] = None):
        self.at_step = int(at_step)
        self.signum = int(signum)
        self.pid = pid
        self.fired = False

    def on_step(self, trainer, step: int) -> None:  # noqa: ARG002
        if not self.fired and step == self.at_step:
            self.fired = True
            os.kill(self.pid if self.pid is not None else os.getpid(),
                    self.signum)


class KillAt(SignalAt):
    """SIGKILL at ``at_step`` — no grace window, no handler, the process
    just disappears (the dead-rank scenario; only ``--save-steps``
    checkpoints survive this one)."""

    def __init__(self, at_step: int, rank: Optional[int] = None):
        super().__init__(at_step, _signal.SIGKILL)
        self.rank = rank  # None = every rank

    def on_step(self, trainer, step: int) -> None:
        if self.rank is not None and _rank() != self.rank:
            return
        super().on_step(trainer, step)


class NaNBatchAt(ChaosInjector):
    """Replace the float tensors of the device batch with NaN at the given
    steps — the divergence-guard trigger for float-input (image) trainers.
    Integer tensors (labels, the LM's tokens) pass through untouched;
    ``keys`` limits the poisoning to those entries of a dict batch."""

    def __init__(self, at_steps: Iterable[int], keys: Optional[Sequence[str]] = None):
        self.at_steps = frozenset(int(s) for s in at_steps)
        self.keys = tuple(keys) if keys is not None else None
        self.injected: list = []

    def on_batch(self, step: int, batch):
        if step not in self.at_steps:
            return batch
        import torch

        def poison(k, v):
            if self.keys is not None and k not in self.keys:
                return v
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return torch.full_like(v, float("nan"))
            return v

        self.injected.append(step)
        if isinstance(batch, dict):
            return {k: poison(k, v) for k, v in batch.items()}
        return poison("", batch)


class LRSpikeAt(ChaosInjector):
    """Set ``trainer.lr`` to an absurd value for exactly one step, then
    restore it — models a transient schedule/overflow bug.  One poisoned
    update corrupts the parameters to inf/NaN; every later step is then
    non-finite (the pattern the divergence guard answers with a rollback)."""

    def __init__(self, at_step: int, value: float = 1e30):
        self.at_step = int(at_step)
        self.value = float(value)
        self._saved: Optional[float] = None

    def on_step(self, trainer, step: int) -> None:
        if step == self.at_step:
            self._saved = trainer.lr
            trainer.lr = self.value
        elif self._saved is not None and step == self.at_step + 1:
            trainer.lr = self._saved
            self._saved = None


class DelayRank(ChaosInjector):
    """Sleep ``seconds`` on each step for the given ranks (None = all) —
    the deterministic straggler for heartbeat/step-lag tests."""

    def __init__(self, seconds: float, ranks: Optional[Sequence[int]] = None,
                 every: int = 1):
        self.seconds = float(seconds)
        self.ranks = frozenset(ranks) if ranks is not None else None
        self.every = max(1, int(every))

    def on_step(self, trainer, step: int) -> None:  # noqa: ARG002
        if step % self.every:
            return
        if self.ranks is not None and _rank() not in self.ranks:
            return
        time.sleep(self.seconds)


class SlowLoader(ChaosInjector):
    """Sleep ``seconds`` in the batch path for the given ranks (None =
    all) — the deterministic input-starved loader.  The delay lands in
    ``on_batch``, which both trainers call inside the step-attribution
    ``data_wait`` window (obs/stepattr.py), so a ``--step-attr`` run
    measures the stall as data wait, not compute."""

    def __init__(self, seconds: float, every: int = 1,
                 ranks: Optional[Sequence[int]] = None):
        self.seconds = float(seconds)
        self.every = max(1, int(every))
        self.ranks = frozenset(ranks) if ranks is not None else None
        self.injected = 0

    def on_batch(self, step: int, batch):
        if step % self.every:
            return batch
        if self.ranks is not None and _rank() not in self.ranks:
            return batch
        self.injected += 1
        time.sleep(self.seconds)
        return batch


class HangAt(ChaosInjector):
    """Stall ``rank`` for ``seconds`` when the loop reaches ``at_step`` —
    inside the collective region (after the flight recorder's
    ``coll_enter``, before the step call), so the stall is what a
    desynced or stuck collective looks like to the rest of the stack.  The
    hang watchdog must flag it within its window, emit a ``hang`` ft_event
    and dump the ring pre-mortem.  Fires once (latched), like
    ``SignalAt``."""

    def __init__(self, at_step: int, seconds: float,
                 rank: Optional[int] = None):
        self.at_step = int(at_step)
        self.seconds = float(seconds)
        self.rank = rank  # None = every rank
        self.fired = False

    def on_collective(self, trainer, step: int) -> None:  # noqa: ARG002
        if self.fired or step != self.at_step:
            return
        if self.rank is not None and _rank() != self.rank:
            return
        self.fired = True
        time.sleep(self.seconds)


class ChaosSchedule(ChaosInjector):
    """Compose injectors; trainers call the schedule, it fans out."""

    def __init__(self, *injectors: ChaosInjector):
        self.injectors = list(injectors)

    def on_step(self, trainer, step: int) -> None:
        for inj in self.injectors:
            inj.on_step(trainer, step)

    def on_batch(self, step: int, batch):
        for inj in self.injectors:
            batch = inj.on_batch(step, batch)
        return batch

    def on_collective(self, trainer, step: int) -> None:
        for inj in self.injectors:
            inj.on_collective(trainer, step)


def corrupt_file(path: str, mode: str = "flip", seed: int = 0,
                 nbytes: int = 1) -> Dict[str, object]:
    """Byte-level checkpoint corruption, deterministic in ``seed``.

    - ``mode="flip"``: XOR a random bit in each of ``nbytes`` seed-chosen
      byte offsets (the cosmic-ray / bad-DIMM model);
    - ``mode="truncate"``: cut the file to a seed-chosen 10–90% of its
      size (the torn-write / out-of-quota model).

    Returns a description dict (mode, offsets or new size).  Offsets depend
    only on ``(seed, file size)``, the JAX function's draws: identical files
    corrupt identically in both packages."""
    import numpy as np

    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file '{path}'")
    rng = np.random.default_rng((int(seed), size))
    if mode == "flip":
        offsets = sorted(
            int(o) for o in rng.choice(size, size=min(nbytes, size),
                                       replace=False)
        )
        masks = [1 << int(b) for b in rng.integers(0, 8, size=len(offsets))]
        with open(path, "r+b") as f:
            for off, mask in zip(offsets, masks):
                f.seek(off)
                byte = f.read(1)[0]
                f.seek(off)
                f.write(bytes([byte ^ mask]))
        return {"mode": "flip", "offsets": offsets, "masks": masks}
    if mode == "truncate":
        new_size = max(1, int(size * rng.uniform(0.1, 0.9)))
        with open(path, "r+b") as f:
            f.truncate(new_size)
        return {"mode": "truncate", "old_size": size, "new_size": new_size}
    raise ValueError(f"unknown corruption mode {mode!r}: expected "
                     "'flip' or 'truncate'")
