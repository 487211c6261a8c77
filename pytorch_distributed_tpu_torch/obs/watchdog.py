"""Recapture watchdog: the port's twin of ``pytorch_distributed_tpu/obs/watchdog.py``.

In the JAX package a steady-state loop compiles each jitted step exactly
once, and the watchdog counts XLA compilations per labelled region
(``watch("serve_decode")``): every compile past ``warmup_compiles`` means a
shape, dtype or donation signature quietly changed, and is booked as a
``recompile`` event in the metrics JSONL.

The port's counterpart of that compile is a CUDA-graph **capture**.  The
serving engine captures its decode step once (``serving/engine.py``); a
second capture of the same step means the engine rebuilt the graph (new
buffers, a changed batch shape) and paid the capture again.  So the engine
reports each capture to ``on_capture`` from inside ``watch(label)``, and
captures beyond ``warmup_compiles`` per label are counted, printed and
logged as ``recompile`` events with the JAX event's fields (``label``,
``compile_index``, ``duration_s``, ``step``).  Eager work (prefill, the
whole engine on the CPU) captures nothing and books nothing.  So the JAX
engine's two watch points, ``watch("serve_prefill")`` around each prefill
and ``watch("serve_decode")`` around each decode call (where jit may
compile), have no counterpart in the port's step: an eager prefill and a
graph replay can never capture, and the one ``watch("serve_decode")`` is
around the capture itself.

There is no process-wide capture callback in torch, so ``install()`` only
arms the watchdog (its signature is the JAX one's); a watchdog that is not
installed ignores what it is told.  The trainers' steps run eagerly, so
their ``--watch-recompiles`` still exits (ROADMAP.md item A12).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

UNATTRIBUTED = "<unattributed>"


class _Watch:
    """Reentrant-per-call context: sets the calling thread's label."""

    def __init__(self, wd: "RecompileWatchdog", label: str, step: Optional[int]):
        self.wd, self.label, self.step = wd, label, step

    def __enter__(self):
        tl = self.wd._tl
        self.prev = (getattr(tl, "label", None), getattr(tl, "step", None))
        tl.label, tl.step = self.label, self.step
        return self

    def __exit__(self, *exc):
        self.wd._tl.label, self.wd._tl.step = self.prev
        return False


class RecompileWatchdog:
    """Counts graph captures per labelled region; flags any capture past
    ``warmup_compiles`` for that label as an anomaly.

    >>> wd = RecompileWatchdog(obs=logger).install()
    >>> with wd.watch("serve_decode", step=i):
    ...     graph = capture(step_fn)
    ...     wd.on_capture(seconds)
    >>> wd.uninstall()

    Attribution is thread-local; a capture outside any ``watch`` lands
    under ``<unattributed>`` and is counted but never flagged.
    """

    def __init__(self, obs: Any = None, warmup_compiles: int = 1):
        if warmup_compiles < 1:
            raise ValueError(f"warmup_compiles must be >= 1, got {warmup_compiles}")
        self.obs = obs
        self.warmup_compiles = int(warmup_compiles)
        self.compiles: Dict[str, int] = {}
        self.anomalies: List[dict] = []
        self._tl = threading.local()
        self._installed = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "RecompileWatchdog":
        self._installed = True
        return self

    def uninstall(self) -> None:
        self._installed = False

    def __enter__(self) -> "RecompileWatchdog":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------ attribution
    def watch(self, label: str, step: Optional[int] = None) -> _Watch:
        """Attribute captures made by this thread inside the context to
        ``label`` (wrapped right around the capture)."""
        return _Watch(self, str(label), step)

    # ---------------------------------------------------------------- events
    def on_capture(self, duration_secs: float) -> None:
        """One CUDA-graph capture, of ``duration_secs``, just happened."""
        if not self._installed:
            return
        label = getattr(self._tl, "label", None) or UNATTRIBUTED
        step = getattr(self._tl, "step", None)
        with self._lock:
            n = self.compiles.get(label, 0) + 1
            self.compiles[label] = n
        if label == UNATTRIBUTED or n <= self.warmup_compiles:
            return
        anomaly = {"label": label, "compile_index": n, "duration_s": float(duration_secs)}
        if step is not None:
            anomaly["step"] = int(step)
        self.anomalies.append(anomaly)
        print(f"!! recompile watchdog: {label} captured again "
              f"(#{n}, {duration_secs:.2f}s"
              + (f", step {step}" if step is not None else "") + ") — "
              "the graph was rebuilt after warmup", flush=True)
        if self.obs is not None and hasattr(self.obs, "log_event"):
            self.obs.log_event("recompile", step=step, label=label, compile_index=n,
                               duration_s=float(duration_secs))
