"""Cross-process heartbeats + straggler detection: a copy of
``pytorch_distributed_tpu/obs/heartbeat.py`` (stdlib only), beats in the
same files and fields, so either package's readers fold either's runs.

Every process appends periodic ``{pid, step, t}`` beats to a shared run
directory, and a monitor (``find_stragglers``) flags processes whose latest
step lags the front-runner or whose newest beat has gone stale — the
signals that distinguish "one slow host" from "everyone is slow" before a
hung collective turns into a silent stall.

Deliberately stdlib-only (no torch import): the monitor side runs anywhere,
and the writer adds no device work to the hot loop (one small file rewrite
per ``interval_s``).

- **Atomic writes.**  Each beat rewrites the whole (capped) line buffer to
  a tmp file and ``os.replace``s it into place, so a reader never sees a
  torn line and a SIGKILLed writer leaves a fully-parseable file.
- **Membership epoch.**  Every beat stamps the writer's ``epoch`` and
  ``world``; ``read_heartbeats(min_epoch=...)`` filters beats of a prior
  incarnation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

_PREFIX = "heartbeat-"


def sample_process_memory() -> Optional[int]:
    """Best-effort per-process memory sample, in bytes.

    Device-first: when torch is already imported and has initialised CUDA
    (the trainer side), this process's allocated bytes on its current card
    (``torch.cuda.memory_allocated``, the caching allocator's
    ``allocated_bytes.all.current``: live tensors, the thing that OOMs), the
    twin of the JAX package's ``bytes_in_use``.  Otherwise (a CPU run) the
    process RSS from ``/proc/self/status``.  Never imports torch itself
    (this module stays stdlib-only for the monitor side) and never raises;
    returns None when nothing is measurable."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                return int(torch.cuda.memory_allocated())
        except Exception:
            pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


class HeartbeatWriter:
    """Appends ``{pid, step, t}`` beats for one process to
    ``<hb_dir>/heartbeat-<pid>.jsonl``.

    ``beat(step)`` is safe to call every step: writes are rate-limited to
    one per ``interval_s`` (0 = every call, for tests).  ``close(step)``
    forces a final beat so the monitor sees the true last step even when
    the run ends mid-interval.
    """

    #: Lines retained per heartbeat file; the monitor only ever reads the
    #: newest parseable record, older lines are debugging history.
    MAX_LINES = 512

    def __init__(self, hb_dir: str, process_index: int = 0,
                 interval_s: float = 5.0, world: Optional[int] = None,
                 epoch: int = 0):
        self.dir = hb_dir
        self.process_index = int(process_index)
        self.interval_s = float(interval_s)
        # Membership identity: the trainer bumps these on re-mesh so every
        # subsequent beat is attributable to the new incarnation.
        self.world = None if world is None else int(world)
        self.epoch = int(epoch)
        self.path = os.path.join(hb_dir, f"{_PREFIX}{self.process_index:05d}.jsonl")
        os.makedirs(hb_dir, exist_ok=True)
        self._last = float("-inf")
        self._lines: list = []
        if os.path.exists(self.path):
            # A restarted incarnation inherits the file; keep its tail as
            # history rather than clobbering forensic context.
            try:
                with open(self.path) as f:
                    self._lines = f.read().splitlines()[-self.MAX_LINES:]
            except OSError:
                self._lines = []

    def set_membership(self, world: int, epoch: int) -> None:
        """Called by the trainer on re-mesh: subsequent beats carry the new
        world size and membership epoch."""
        self.world = int(world)
        self.epoch = int(epoch)

    def beat(self, step: int, force: bool = False,
             step_time_ema: Optional[float] = None,
             last_ft: Optional[str] = None,
             mem_bytes: Optional[int] = None,
             data_wait_ms: Optional[float] = None) -> bool:
        """Record a beat at ``step``; returns True when a line was written.

        ``step_time_ema`` (seconds) and ``last_ft`` (the most recent
        ft_event kind) ride along when given, so the monitor can tell a
        *slow* rank (fresh beats, fat EMA) from a *dead* one (stale beats)
        and see whether the rank already said why it is behind.
        ``mem_bytes`` (``sample_process_memory``) rides along the same
        way: a rank creeping toward OOM announces it beats ahead.
        ``data_wait_ms`` (the --step-attr data-wait EMA) lets
        ``find_stragglers`` name an *input-starved* rank — slow because
        its loader is, not because its device is."""
        now = time.time()
        if not force and now - self._last < self.interval_s:
            return False
        self._last = now
        rec = {"pid": self.process_index, "step": int(step), "t": now,
               "epoch": self.epoch}
        if self.world is not None:
            rec["world"] = self.world
        if step_time_ema is not None:
            rec["ema"] = float(step_time_ema)
        if last_ft is not None:
            rec["last_ft"] = str(last_ft)
        if mem_bytes is not None:
            rec["mem"] = int(mem_bytes)
        if data_wait_ms is not None:
            rec["data_wait"] = round(float(data_wait_ms), 3)
        self._lines.append(json.dumps(rec))
        del self._lines[:-self.MAX_LINES]
        # Atomic rewrite: liveness decisions (elastic eviction) must never
        # act on a torn record, and a writer killed mid-beat must leave
        # the previous complete file behind, not a half-written line.
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("\n".join(self._lines) + "\n")
        os.replace(tmp, self.path)
        return True

    def close(self, step: Optional[int] = None,
              step_time_ema: Optional[float] = None,
              last_ft: Optional[str] = None,
              mem_bytes: Optional[int] = None,
              data_wait_ms: Optional[float] = None) -> None:
        if step is not None:
            self.beat(step, force=True, step_time_ema=step_time_ema,
                      last_ft=last_ft, mem_bytes=mem_bytes,
                      data_wait_ms=data_wait_ms)


def read_heartbeats(hb_dir: str,
                    min_epoch: Optional[int] = None) -> Dict[int, dict]:
    """Latest beat per process: ``{pid: {"pid", "step", "t", ...}}``.

    Tolerates a torn final line (a writer killed mid-append, or a file
    from before the atomic-rewrite hardening) by walking back to the
    newest parseable record.

    ``min_epoch`` filters out beats stamped with an older membership
    epoch: after a re-mesh, a prior incarnation's beats must not be
    mistaken for live ranks.  Beats without an epoch field (pre-elastic
    writers) count as epoch 0.
    """
    beats: Dict[int, dict] = {}
    if not os.path.isdir(hb_dir):
        return beats
    for name in sorted(os.listdir(hb_dir)):
        if not (name.startswith(_PREFIX) and name.endswith(".jsonl")):
            continue
        with open(os.path.join(hb_dir, name)) as f:
            lines = f.read().splitlines()
        for line in reversed(lines):
            try:
                rec = json.loads(line)
                if (min_epoch is not None
                        and int(rec.get("epoch", 0)) < min_epoch):
                    break  # newest record is stale; older ones are too
                beats[int(rec["pid"])] = rec
                break
            except (ValueError, KeyError, TypeError):
                continue
    return beats


def _median(vals):
    s = sorted(vals)
    return s[len(s) // 2] if s else None


def fleet_rollup(beats: Dict[int, dict],
                 now: Optional[float] = None) -> Dict[str, object]:
    """Aggregate one ``read_heartbeats`` snapshot into the fleet-level
    scalars the JAX package's live dashboard (``scripts/obs_live.py``)
    renders: rank
    count, step front/back, oldest beat age, median step-time EMA, and
    total sampled memory.  Empty snapshot → ``{}``."""
    if not beats:
        return {}
    if now is None:
        now = time.time()
    steps = [int(b.get("step", 0)) for b in beats.values()]
    ages = [max(0.0, now - float(b.get("t", now))) for b in beats.values()]
    emas = [float(b["ema"]) for b in beats.values() if "ema" in b]
    mems = [int(b["mem"]) for b in beats.values()
            if b.get("mem") is not None]
    return {
        "ranks": len(beats),
        "min_step": min(steps),
        "max_step": max(steps),
        "oldest_beat_age_s": max(ages),
        "median_ema_s": _median(emas),
        "total_mem_bytes": sum(mems) if mems else None,
        "worlds": sorted({b["world"] for b in beats.values()
                          if b.get("world") is not None}),
        "epochs": sorted({int(b.get("epoch", 0))
                          for b in beats.values()}),
    }


def find_stragglers(
    beats: Dict[int, dict],
    now: Optional[float] = None,
    max_step_lag: int = 3,
    max_age_s: float = 60.0,
    slow_ema_factor: float = 2.0,
) -> Dict[int, str]:
    """Flag straggling processes → ``{pid: human-readable reason}``.

    Three signals, distinguishing *slow* ranks from *dead* ranks:
    - **step lag**: the process's latest step trails the front-runner by
      more than ``max_step_lag`` (collectives will rate-limit everyone to
      it).  When beats carry a step-time EMA, a fat EMA vs the fleet
      median (> ``slow_ema_factor``x) marks the rank as *slow* — alive
      but dragging, the "replace the host" case;
    - **beat age**: the newest beat is older than ``max_age_s`` — *dead or
      hung*, the one the lock-stepped mesh cannot see from step counters
      alone, since a stuck rank stalls every rank's step;
    - a beat's ``last_ft`` event kind is appended to the reason when
      present, so a rank that already said why it is behind (preempt,
      rollback) reads differently from a silent one;
    - a beat's per-process memory sample (``mem``, bytes) is appended
      the same way — a flagged rank whose memory sits far above the
      fleet's reads as "about to OOM", not merely slow;
    - a beat's ``data_wait`` EMA (milliseconds, from ``--step-attr``)
      reclassifies a slow rank as **input-starved** when the wait is the
      majority of its step time — "fix the loader", not "replace the
      host".
    """
    if not beats:
        return {}
    if now is None:
        now = time.time()
    lead = max(b["step"] for b in beats.values())
    # Fleet-median EMA over *fresh* ranks only: a dead rank's stale EMA
    # must not drag the baseline.
    med_ema = _median([b["ema"] for b in beats.values()
                       if "ema" in b and now - b["t"] <= max_age_s])
    flagged: Dict[int, str] = {}
    for pid in sorted(beats):
        b = beats[pid]
        reasons = []
        lag = lead - b["step"]
        age = now - b["t"]
        if lag > max_step_lag:
            reason = (f"step lag {lag} > {max_step_lag} "
                      f"(at step {b['step']}, lead {lead})")
            ema = b.get("ema")
            if (age <= max_age_s and ema is not None and med_ema
                    and ema > slow_ema_factor * med_ema):
                dw = b.get("data_wait")
                if dw is not None and dw > 0.5 * float(ema) * 1e3:
                    reason += (f"; input-starved rank: data_wait ema "
                               f"{dw:.1f}ms of step-time ema "
                               f"{float(ema) * 1e3:.1f}ms — loader, "
                               f"not device")
                else:
                    reason += (f"; slow rank: step-time ema {ema:.3f}s vs "
                               f"fleet median {med_ema:.3f}s")
            reasons.append(reason)
        if age > max_age_s:
            reasons.append(
                f"beat age {age:.1f}s > {max_age_s:.0f}s (dead or hung)")
        if reasons and b.get("last_ft"):
            reasons.append(f"last ft_event: {b['last_ft']}")
        if reasons and b.get("mem") is not None:
            reasons.append(f"mem {b['mem'] / 2**20:.0f} MiB")
        if reasons:
            flagged[pid] = "; ".join(reasons)
    return flagged
