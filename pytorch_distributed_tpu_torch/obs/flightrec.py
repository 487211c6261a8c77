"""Per-rank distributed flight recorder: a copy of
``pytorch_distributed_tpu/obs/flightrec.py`` (stdlib only; its memory sample
is the port's ``sample_process_memory``), dumps in the same files and
fields, so either package's postmortem reads either's.

Every distributed recipe shares the classic failure mode: one rank dies or
desyncs inside a collective and the whole job hangs with zero forensics.
This module records what each rank was doing when things went wrong, with
three pieces:

``FlightRecorder``
    A bounded in-memory ring buffer (fixed-size ``collections.deque`` of
    compact event tuples — step begin/end, collective entry/exit with
    kind+bytes from the comm ledger, ft_events, membership-epoch changes,
    checkpoint saves, signals) that costs ~zero on the hot path: a
    ``record()`` is one tuple allocation and a deque append — no host
    sync, no I/O, no lock.  ``dump(reason)`` serializes the ring plus the
    forensic scalars (last-entered collective, last heartbeat fields,
    membership epoch, process memory, step-time p50/p95) to
    ``flightrec_rank<k>.json`` atomically (tmp + ``os.replace``) and
    never raises — it runs on death paths where a secondary failure must
    not mask the primary one.

``FlightSignalDump``
    A ``parse_signals``-compatible signal installer that dumps the ring
    and then *chains* to the previously installed handler (the
    ``PreemptionGuard._handler`` idiom), so ``--flight-rec`` composes
    with ``--preempt-signals`` on the same signal set.

``HangWatchdog``
    A daemon thread that flags a step exceeding ``max(timeout, K×p95)``
    of completed step times: it emits a ``hang`` ft_event (with the
    last-entered collective attached), records it in the ring, and dumps
    the ring pre-mortem — once per stalled step (the latch re-arms when
    the step id advances), so a genuine multi-minute stall produces one
    dump, not a flood.  It times the host's step window: a gloo
    collective blocks the host inside the step, so a stall shows there;
    an NCCL one is enqueued and returns, so the stall shows in the step
    where the host next waits on the card.

The port has no comm ledger yet (ROADMAP.md item A13), so the trainers
enter the collective region with kind and bytes None, as a JAX run without
``--comm-ledger`` does.

``tools/postmortem.py`` merges the per-rank dumps (aligning clocks via
the heartbeat history) into a cross-rank root-cause report: which rank
stalled first, the desync frontier (last collective each rank entered),
step skew, membership epoch at death, per-rank memory at death.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from pytorch_distributed_tpu_torch.obs.heartbeat import sample_process_memory

__all__ = [
    "FlightRecorder",
    "FlightSignalDump",
    "HangWatchdog",
    "DEFAULT_CAPACITY",
    "DEFAULT_HANG_TIMEOUT",
    "attach_to_metrics",
    "dump_path",
    "find_dumps",
]

DEFAULT_CAPACITY = 2048
DEFAULT_HANG_TIMEOUT = 30.0  # the max(30s, K×p95) floor
SCHEMA_VERSION = 1
_PREFIX = "flightrec_rank"


def dump_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"{_PREFIX}{int(rank)}.json")


def find_dumps(out_dir: str) -> Dict[int, str]:
    """``{rank: path}`` for every ``flightrec_rank<k>.json`` under
    ``out_dir`` (non-recursive; silent on a missing directory)."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(out_dir)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith(_PREFIX) and name.endswith(".json")):
            continue
        digits = name[len(_PREFIX):-len(".json")]
        if digits.isdigit():
            out[int(digits)] = os.path.join(out_dir, name)
    return out


class FlightRecorder:
    """Bounded per-rank event ring + atomic postmortem dump.

    Hot-path contract: ``record()`` and the ``step_begin``/``coll_enter``/
    ``coll_exit``/``step_end`` helpers do one deque append and a couple of
    scalar stores — no syncs, no syscalls.  All I/O lives in ``dump()``,
    which only runs on death paths (or explicitly at end of fit)."""

    def __init__(self, out_dir: str, *, rank: int = 0,
                 capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.out_dir = out_dir
        self.rank = int(rank)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._total = 0               # events ever recorded (for drop count)
        # Current-step scalars the watchdog polls (GIL-atomic stores).
        self._step_t0: Optional[float] = None
        self._cur_step: Optional[int] = None
        self._step_times: deque = deque(maxlen=512)
        # Forensic scalars carried whole into the dump header.
        self.last_collective: Optional[Dict[str, Any]] = None
        self.last_heartbeat: Optional[Dict[str, Any]] = None
        self.membership: Dict[str, Any] = {"world": None, "epoch": 0}
        self.dump_reasons: List[str] = []

    # ------------------------------------------------------------- ring --
    def record(self, kind: str, step: Optional[int] = None,
               **fields: Any) -> None:
        """Append one compact event tuple; O(1), never blocks."""
        self._ring.append((time.time(), kind, step, fields or None))
        self._total += 1

    def step_begin(self, step: int) -> None:
        self._cur_step = step
        self._step_t0 = time.time()
        self.record("step_begin", step)

    def coll_enter(self, step: int, kind: Optional[str] = None,
                   bytes: Optional[float] = None,
                   name: Optional[str] = None) -> None:
        """Entering the compiled step's collective region.  ``kind``/
        ``bytes`` come from the comm ledger's dominant entry when the
        ``--comm-ledger`` lowering ran; None otherwise (the frontier then
        reports the step region without a collective label)."""
        self.last_collective = {
            "step": step, "kind": kind, "bytes": bytes, "name": name,
            "t": time.time(),
        }
        self.record("coll_enter", step, collective=kind, bytes=bytes)

    def coll_exit(self, step: int) -> None:
        self.record("coll_exit", step)

    def step_end(self, step: int, dt: Optional[float] = None) -> None:
        t = time.time()
        if dt is None and self._step_t0 is not None:
            dt = t - self._step_t0
        if dt is not None:
            self._step_times.append(float(dt))
        # Clear the in-step flag BEFORE the ring append so the watchdog
        # never sees a completed step as still running.
        self._step_t0 = None
        self.record("step_end", step,
                    dt=None if dt is None else round(float(dt), 6))

    def event(self, kind: str, step: Optional[int] = None,
              **fields: Any) -> None:
        """ft_events / checkpoint / remesh — same ring, explicit name for
        call sites that mirror ``MetricsLogger.log_event``."""
        self.record(kind, step, **fields)

    def heartbeat(self, fields: Dict[str, Any]) -> None:
        """Remember the last heartbeat record (scalar slot, not a ring
        entry — beats would otherwise crowd out real events)."""
        self.last_heartbeat = dict(fields)

    def set_membership(self, world: Optional[int], epoch: int) -> None:
        self.membership = {"world": world, "epoch": int(epoch)}
        self.record("membership", None, world=world, epoch=int(epoch))

    # --------------------------------------------------- watchdog reads --
    def in_step(self) -> Optional[Tuple[int, float]]:
        """``(step, elapsed_s)`` while inside a step, else None."""
        t0 = self._step_t0
        if t0 is None:
            return None
        return (self._cur_step if self._cur_step is not None else -1,
                time.time() - t0)

    def step_time_quantile(self, q: float) -> Optional[float]:
        """Quantile over completed step times; None below 5 samples (the
        watchdog then falls back to its fixed timeout floor)."""
        times = sorted(self._step_times)
        if len(times) < 5:
            return None
        idx = min(len(times) - 1, int(q * (len(times) - 1) + 0.5))
        return times[idx]

    # -------------------------------------------------------------- dump --
    def snapshot(self, reason: str) -> Dict[str, Any]:
        times = sorted(self._step_times)
        n = len(times)
        cur = self.in_step()
        return {
            "schema": SCHEMA_VERSION,
            "rank": self.rank,
            "pid": os.getpid(),
            "reason": reason,
            "t_dump": time.time(),
            "capacity": self.capacity,
            "events_total": self._total,
            "events_dropped": max(0, self._total - len(self._ring)),
            "last_collective": self.last_collective,
            "last_heartbeat": self.last_heartbeat,
            "membership": dict(self.membership),
            "in_step": (None if cur is None
                        else {"step": cur[0], "elapsed_s": round(cur[1], 6)}),
            "step_times": {
                "count": n,
                "p50": times[n // 2] if n else None,
                "p95": times[min(n - 1, int(0.95 * n))] if n else None,
            },
            "mem_bytes": sample_process_memory(),
            "events": [
                {"t": t, "kind": kind, "step": step,
                 **(fields if fields else {})}
                for (t, kind, step, fields) in list(self._ring)
            ],
        }

    def dump(self, reason: str) -> Optional[str]:
        """Atomic best-effort dump; returns the path or None on failure.
        Runs on death paths — swallows everything (a dump failure must
        never mask the primary error or re-enter a signal handler)."""
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = dump_path(self.out_dir, self.rank)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                # default=str: ring fields may hold device scalars or
                # other non-JSON values; a dump must never raise over one.
                json.dump(self.snapshot(reason), f, default=str)
                f.write("\n")
            os.replace(tmp, path)
            self.dump_reasons.append(reason)
            return path
        except Exception:
            return None


def attach_to_metrics(recorder: FlightRecorder, obs: Any,
                      skip: Tuple[str, ...] = ("hang",)) -> None:
    """Mirror every ``obs.log_event`` ft_event (skip / rollback / preempt /
    remesh / checkpoint, including ones emitted from inside
    ``DivergenceGuard``) into the flight ring by wrapping the bound
    method.  ``hang`` is skipped by default — the watchdog records it in
    the ring itself before calling ``log_event``."""
    orig = obs.log_event

    def log_event(kind, step=None, **fields):
        if kind not in skip:
            try:
                recorder.record(str(kind), step, **fields)
            except Exception:
                pass
        return orig(kind, step=step, **fields)

    obs.log_event = log_event


class FlightSignalDump:
    """Dump the ring on fatal/preemption signals, then chain to whatever
    handler was installed before (``PreemptionGuard`` chains the same way,
    so install order between the two does not matter)."""

    def __init__(self, recorder: FlightRecorder,
                 signals: Iterable[int] = (_signal.SIGTERM,)):
        self.recorder = recorder
        self.signals = tuple(signals)
        self._prev: Dict[int, Any] = {}
        self._installed = False

    def _handler(self, signum, frame) -> None:
        self.recorder.record("signal", None, signum=int(signum))
        self.recorder.dump(f"signal:{int(signum)}")
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "FlightSignalDump":
        for s in self.signals:
            self._prev[s] = _signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s in self.signals:
            prev = self._prev.get(s)
            _signal.signal(s, prev if prev is not None else _signal.SIG_DFL)
        self._installed = False


class HangWatchdog:
    """Collective-hang watchdog: a daemon thread flagging a step that
    exceeds ``max(timeout, k×p95)`` of completed step times.

    On firing it (1) records a ``hang`` event in the ring with the
    last-entered collective attached, (2) emits a ``hang`` ft_event via
    the metrics logger (so heartbeats carry ``last_ft=hang`` and the
    goodput/report layers see it), and (3) dumps the ring pre-mortem.
    Fires **once per stalled step** — the latch re-arms only when the
    step id advances, so there is no flapping while the stall persists."""

    def __init__(self, recorder: FlightRecorder, *,
                 obs: Any = None,
                 timeout: float = DEFAULT_HANG_TIMEOUT,
                 k: float = 4.0,
                 poll_s: Optional[float] = None):
        self.recorder = recorder
        self.obs = obs
        self.timeout = float(timeout)
        self.k = float(k)
        # Poll fast enough to catch a short drill timeout, slow enough to
        # stay invisible next to a 30s production floor.
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.02, min(0.5, self.timeout / 8.0)))
        self.hangs = 0
        self._flagged_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def threshold(self) -> float:
        p95 = self.recorder.step_time_quantile(0.95)
        if p95 is None:
            return self.timeout
        return max(self.timeout, self.k * p95)

    def check(self, now_elapsed: Optional[Tuple[int, float]] = None) -> bool:
        """One watchdog evaluation; split out so tests can drive it
        without waiting on the thread.  Returns True when it fired."""
        cur = (self.recorder.in_step() if now_elapsed is None
               else now_elapsed)
        if cur is None:
            return False
        step, elapsed = cur
        if step == self._flagged_step:
            return False              # already fired for this stall
        if elapsed <= self.threshold():
            return False
        self._flagged_step = step
        self.hangs += 1
        coll = self.recorder.last_collective or {}
        self.recorder.record(
            "hang", step, elapsed_s=round(elapsed, 3),
            threshold_s=round(self.threshold(), 3),
            collective=coll.get("kind"))
        if self.obs is not None:
            try:
                self.obs.log_event(
                    "hang", step=step, elapsed_s=round(elapsed, 3),
                    collective=coll.get("kind") or "",
                    collective_bytes=coll.get("bytes") or 0)
            except Exception:
                pass                  # forensics must not kill the run
        self.recorder.dump("hang")
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                pass

    def start(self) -> "HangWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="flightrec-hang-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None
