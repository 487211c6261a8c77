"""Structured per-step metrics: one JSONL record per step.

A copy of ``pytorch_distributed_tpu/obs/metrics.py``, which imports no
JAX: the serving engine's SLO percentiles, ``serve_lm --metrics-jsonl`` and
both trainers' ``--metrics-jsonl`` use it, and ``read_metrics`` reads the
records back.  ``MetricsLogger`` is the trainers' one observability hub:

- ``log_step`` buffers a structured record — step index, wall time,
  step-time EMA and windowed p50/p95/max, items/s throughput, lr, and any
  device scalars, which stay unconverted until flush time, so the hot loop
  never blocks on a device→host sync;
- records drain to the JSONL file every ``flush_every`` steps and at
  ``close()``;
- other instrumentation registers as sinks of the same logger: a
  ``start``/``stop`` pair, an ``epoch_start``/``epoch_end`` pair, or any
  callable invoked once per drained record.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Any, Dict, List, Optional, Sequence

def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def read_metrics(path: str) -> List[dict]:
    """Parse a metrics JSONL file back into records (schema round-trip)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


class MetricsLogger:
    """Per-step structured metrics with lazy device-scalar conversion.

    ``path=None`` still works as the observability hub (sink lifecycle,
    epoch events) — it just writes no JSONL.
    """

    def __init__(self, path: Optional[str] = None, process_index: int = 0,
                 flush_every: int = 50, ema_alpha: float = 0.1,
                 window: int = 256):
        self.path = path
        self.process_index = int(process_index)
        self.flush_every = max(1, int(flush_every))
        self.ema_alpha = float(ema_alpha)
        self._pending: List[Dict[str, Any]] = []
        self._times: collections.deque = collections.deque(maxlen=window)
        self._ema: Optional[float] = None
        # Last event kind logged (skip/rollback/preempt/recompile): the
        # heartbeat writer stamps it into beats so the straggler monitor
        # can tell a rank that *said why* it is behind from a silent one.
        self.last_event_kind: Optional[str] = None
        self._file = None
        self._step_sinks: List[Any] = []
        self._epoch_sinks: List[Any] = []
        self._owned: List[Any] = []  # start()ed at register, stop()ped at close

    # ----------------------------------------------------------------- sinks
    def register(self, sink):
        """Attach instrumentation to this logger (duck-typed):

        - ``start``/``stop`` pair (TelemetrySampler): started now, stopped
          at ``close()``;
        - ``epoch_start``/``epoch_end`` pair (EpochCSVLogger): driven by
          this logger's epoch events;
        - plain callable: invoked with each drained record dict.
        Returns the sink for chaining.
        """
        if sink is None:
            return sink
        if hasattr(sink, "start") and hasattr(sink, "stop"):
            sink.start()
            self._owned.append(sink)
            return sink
        if hasattr(sink, "epoch_start") and hasattr(sink, "epoch_end"):
            self._epoch_sinks.append(sink)
            return sink
        if callable(sink):
            self._step_sinks.append(sink)
            return sink
        raise TypeError(
            f"unsupported sink {type(sink).__name__}: expected start/stop, "
            "epoch_start/epoch_end, or a callable")

    def epoch_start(self) -> None:
        for s in self._epoch_sinks:
            s.epoch_start()

    def epoch_end(self) -> Optional[float]:
        """Forward to epoch sinks; returns the last sink's value (the
        EpochCSVLogger convention: elapsed seconds)."""
        out = None
        for s in self._epoch_sinks:
            out = s.epoch_end()
        return out

    # ----------------------------------------------------------------- steps
    @property
    def ema(self) -> Optional[float]:
        """Current step-time EMA (None before the first step) — exported so
        heartbeats can carry it (obs/heartbeat.py slow-vs-dead signal)."""
        return self._ema

    @property
    def enabled(self) -> bool:
        """True when some step sink (JSONL file or callable) consumes
        records; ``log_step`` is a no-op otherwise, so a hub built only for
        epoch/telemetry sinks adds zero per-step work."""
        return bool(self.path or self._step_sinks)

    def log_step(self, step: int, step_time: float,
                 n_items: Optional[float] = None, lr=None,
                 scalars: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> None:
        """Buffer one step record.

        ``step_time`` is host-measured seconds (already a float);
        ``n_items`` yields ``throughput`` = items/s (images or tokens);
        ``scalars``/``lr`` may be unready device scalars — they are NOT
        converted here (no host sync); conversion happens at flush.
        """
        if not self.enabled:
            return
        st = float(step_time)
        self._ema = (st if self._ema is None
                     else self.ema_alpha * st + (1.0 - self.ema_alpha) * self._ema)
        self._times.append(st)
        ordered = sorted(self._times)
        rec: Dict[str, Any] = {
            "step": int(step),
            "t": time.time(),
            "process": self.process_index,
            "step_time": st,
            "step_time_ema": self._ema,
            "step_time_p50": _percentile(ordered, 0.50),
            "step_time_p95": _percentile(ordered, 0.95),
            "step_time_max": ordered[-1],
        }
        if n_items is not None:
            rec["throughput"] = (float(n_items) / st) if st > 0 else 0.0
        if lr is not None:
            rec["lr"] = lr  # possibly a device scalar; converted at flush
        if scalars:
            rec.update(scalars)
        if extra:
            rec.update(extra)
        self._pending.append(rec)
        if len(self._pending) >= self.flush_every:
            self.flush()

    def log_event(self, kind: str, step: Optional[int] = None,
                  **fields: Any) -> None:
        """Buffer one structured *event* record (``{"ft_event": kind, …}``)
        through the same pending/flush pipeline as step records — the FT
        subsystem's skip/rollback/preemption trail (ft/divergence.py;
        summarized by ``scripts/obs_report.py``).  Events are rare, so they
        flush immediately: a crash right after a preemption event must not
        lose the record that explains the crash."""
        self.last_event_kind = str(kind)  # beats carry it even w/o a sink
        if not self.enabled:
            return
        rec: Dict[str, Any] = {
            "ft_event": str(kind),
            "t": time.time(),
            "process": self.process_index,
        }
        if step is not None:
            rec["step"] = int(step)
        rec.update(fields)
        self._pending.append(rec)
        self.flush()

    def flush(self) -> None:
        """Drain pending records: convert device scalars (the one host sync,
        amortized over ``flush_every`` steps), write JSONL, notify sinks."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for rec in pending:
            for k, v in rec.items():
                if not isinstance(v, (int, float, str, bool, type(None))):
                    rec[k] = float(v)
        if self.path:
            if self._file is None:
                self._file = open(self.path, "a")
            for rec in pending:
                self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        for sink in self._step_sinks:
            for rec in pending:
                sink(rec)

    def close(self) -> None:
        """Flush, stop owned sinks, release the file.  Idempotent; the
        logger stays usable (a later ``log_step`` reopens the file)."""
        self.flush()
        owned, self._owned = self._owned, []
        for s in owned:
            s.stop()
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
