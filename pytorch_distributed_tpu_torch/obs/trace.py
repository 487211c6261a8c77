"""Trace annotation helpers and windowed profiler capture, the port of
``pytorch_distributed_tpu/obs/trace.py`` over ``torch.profiler``.

``scope(name)`` is ``torch.profiler.record_function(name)``: a named span
in the trace around whatever runs inside the ``with`` (the JAX package's
``TraceAnnotation`` + ``named_scope``).  The train steps open the JAX
step's names (``forward``, ``loss_and_metrics``, ``grad_sync``,
``optimizer``; ``lm_forward``, ``grad_clip``) and the trainers open
``train_step`` / ``lm_step`` around each step call.

``ProfileWindow`` drives ``torch.profiler.profile`` from epoch/step windows
so a trace can capture steady state; ``capture(dir)`` is its one-shot
contextmanager form.  Each trace segment is one Chrome trace,
``<dir>/trace_<segment>.pid<pid>.json`` (open it in Perfetto or
``chrome://tracing``).  On a CUDA device the profiler records CPU and CUDA
activity, and a segment that cannot record the card raises: a run asked
to profile the card never writes a host-only trace in its place.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
from typing import Optional, Tuple

import torch

_KERNEL_EVENT = re.compile(r'"cat"\s*:\s*"kernel"')


@contextlib.contextmanager
def scope(name: str):
    """A named span in the profiler trace (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


def annotate(name: str):
    """Decorator form of ``scope`` for whole functions."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with scope(name):
                return fn(*a, **kw)

        return inner

    return wrap


def parse_span(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"5"`` → (5, 6); ``"10:20"`` → (10, 20) — python half-open ranges."""
    if spec is None or spec == "":
        return None
    parts = str(spec).split(":")
    try:
        if len(parts) == 1:
            lo = int(parts[0])
            return (lo, lo + 1)
        if len(parts) == 2:
            lo, hi = int(parts[0]), int(parts[1])
            if hi <= lo:
                raise ValueError
            return (lo, hi)
    except ValueError:
        pass
    raise ValueError(
        f"bad span {spec!r}: expected 'N' or 'LO:HI' with HI > LO")


class _Segment:
    """One ``torch.profiler.profile`` session written as one Chrome trace."""

    def __init__(self, trace_dir: str, index: int, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
                raise RuntimeError("profiling a CUDA run needs the profiler's CUDA activity "
                                   "(CUPTI), which this torch build does not support")
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        self.cuda = cuda
        self.path = os.path.join(trace_dir, f"trace_{index:03d}.pid{os.getpid()}.json")
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        if self.cuda:
            with open(self.path) as f:
                if not _KERNEL_EVENT.search(f.read()):
                    raise RuntimeError(f"the profiler recorded no CUDA kernel in {self.path}: "
                                       "the card's activity was not traced")
        return self.path


def _is_cuda(device) -> bool:
    if device is None:
        return False
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def capture(trace_dir: str, device=None):
    """One-shot profiler capture of everything inside the ``with``; CUDA
    activity too when ``device`` is a CUDA device.  Yields the directory;
    the trace file is written when the block ends."""
    seg = _Segment(trace_dir, 0, _is_cuda(device))
    try:
        yield trace_dir
    finally:
        seg.stop()


class ProfileWindow:
    """Epoch/step-windowed profiler control.

    - no windows: trace the first trained epoch;
    - ``epochs='A'`` / ``'A:B'``: trace those epochs (one trace segment per
      epoch — the segment ends at each epoch end);
    - ``steps='I'`` / ``'I:J'``: within an active epoch, trace only that
      in-epoch step range (steady-state capture past the warm-up).

    ``device``: the run's device; a CUDA one records the card's activity
    too.  ``paths`` lists the traces written.
    """

    def __init__(self, profile_dir: Optional[str], epochs: Optional[str] = None,
                 steps: Optional[str] = None, start_epoch: int = 0, device=None):
        self.dir = profile_dir
        self.epochs = parse_span(epochs)
        self.steps = parse_span(steps)
        self.start_epoch = start_epoch
        self.cuda = _is_cuda(device)
        self.paths: list = []
        self._segment: Optional[_Segment] = None

    def _epoch_active(self, epoch: int) -> bool:
        if not self.dir:
            return False
        if self.epochs is None:
            return epoch == self.start_epoch
        return self.epochs[0] <= epoch < self.epochs[1]

    def epoch_begin(self, epoch: int) -> None:
        if self.steps is None and self._epoch_active(epoch):
            self._start()

    def step_begin(self, epoch: int, step: int) -> None:
        """Call at the top of every train step (cheap when inactive)."""
        if self.steps is None:
            return
        if self._epoch_active(epoch) and self.steps[0] <= step < self.steps[1]:
            self._start()
        else:
            self._stop()

    def epoch_end(self) -> bool:
        """Stop an open trace segment; True when one was written."""
        return self._stop()

    def _start(self) -> None:
        if self._segment is None:
            self._segment = _Segment(self.dir, len(self.paths), self.cuda)

    def _stop(self) -> bool:
        if self._segment is None:
            return False
        seg, self._segment = self._segment, None
        self.paths.append(seg.stop())
        return True
