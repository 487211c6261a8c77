"""Preemption-aware training: the port of ``pytorch_distributed_tpu/utils/preempt.py``.

Machines get reclaimed (maintenance events, spot preemption) with a SIGTERM
grace window.  A signal flips a flag, the epoch and step loops poll it at
safe boundaries (between steps, never inside one, so every rank leaves at
the same step), checkpoint, and stop; ``--resume`` then continues at the
saved step.

Signal handlers are process-global state, so installation is explicit and
reversible (``install()``/``uninstall()``); the previous handler is chained,
not clobbered.  ``parse_signals`` and ``PreemptionGuard`` are copies of the
JAX module's; ``PreemptionAgreement`` is its all-reduce over a
``torch.distributed`` group.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Tuple


def parse_signals(spec: str) -> Tuple[int, ...]:
    """``'term,int'`` / ``'SIGTERM, SIGINT'`` / ``'15'`` → signal numbers.

    The ``--preempt-signals`` parser: SIGTERM is every platform's reclaim
    grace signal; SIGINT is the opt-in for interactive runs where Ctrl-C
    should checkpoint-and-exit instead of stack-tracing (SIGKILL is
    rejected — it cannot be trapped; that case is what ``--save-steps``
    cadence checkpoints are for)."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.isdigit():
            num = int(tok)
        else:
            name = tok.upper()
            if not name.startswith("SIG"):
                name = "SIG" + name
            try:
                num = int(getattr(signal, name))
            except AttributeError:
                raise ValueError(
                    f"unknown signal {tok!r} in --preempt-signals "
                    f"{spec!r}") from None
        if num == int(signal.SIGKILL):
            raise ValueError(
                "--preempt-signals: SIGKILL cannot be trapped; rely on "
                "--save-steps cadence checkpoints for kill-without-grace")
        out.append(num)
    if not out:
        raise ValueError(f"--preempt-signals {spec!r} names no signals")
    return tuple(dict.fromkeys(out))  # dedup, keep order


class PreemptionGuard:
    """Flag-on-signal with handler chaining.

    >>> guard = PreemptionGuard().install()
    >>> ...  # training loop polls guard.triggered between steps
    >>> guard.uninstall()

    Polling is a local ``Event`` check — no collective, no device sync.  All
    processes of a job receive the platform's preemption signal, so each
    rank observes the flag independently and breaks at the same loop
    boundary (the next step's collective never starts anywhere).
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self._signals = signals
        self._flag = threading.Event()
        self._prev: Dict[int, object] = {}

    def _handler(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        """Install handlers (main thread only — a Python restriction)."""
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Set the flag directly (tests; cooperative shutdown)."""
        self._flag.set()


class PreemptionAgreement:
    """Cross-process agreement on the preemption flag.

    Signal delivery skews across hosts: rank 0's flag may set just before a
    loop-boundary check while rank 1's sets just after, so per-rank local
    polling would break the ranks at *different* boundaries and deadlock the
    next collective.  Every rank calls this at the same step; it answers
    "did any rank flag?" with an all-reduce MAX of one int over ``group``,
    so the stop decision itself is bulk-synchronous.  The tensor lives where
    the group's backend reduces: on ``device`` (the card) for NCCL, on the
    CPU for gloo.  Without a group, or in a group of one, the flag is
    answered locally with no collective.
    """

    def __init__(self, group=None, device=None):
        import torch
        import torch.distributed as dist

        self._single = group is None or dist.get_world_size(group) == 1
        if self._single:
            return
        self._group = group
        on_card = dist.get_backend(group) == "nccl"
        self._device = torch.device(device) if on_card else torch.device("cpu")

    def __call__(self, flag: bool) -> bool:
        if self._single:
            return bool(flag)
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self._device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return bool(t.item())
