"""Goodput ledger: how much wall-clock actually became training.

A copy of ``pytorch_distributed_tpu/obs/goodput.py`` (stdlib only).  Folds
one metrics-JSONL stream — per-step records plus ``ft_event`` records —
into a badput taxonomy (the port's trainers book ``skip`` and ``rollback``
under ``--nan-guard`` and ``preempt`` on a preemption; elastic membership,
ROADMAP.md item A11, and the recompile watch, A12, are not ported, so
``remesh`` and ``recompile`` stay zero on its runs):

- ``nan_skip``          steps whose update the divergence guard gated off
                        (the step ran, the arithmetic was wasted);
- ``rollback_discard``  steps trained past the restored snapshot and then
                        thrown away by a rollback;
- ``preempt_gap``       wall time between a preemption event and the first
                        step of the resumed run (the restart appends to
                        the same JSONL, so the gap is visible in one file);
- ``recompile``         post-warmup compilation time (obs/watchdog.py);
- ``remesh``            wall time between an elastic membership change
                        (shrink/grow, ft/elastic.py) and the first step on
                        the rebuilt mesh — teardown, re-shard, and the
                        recompile at the new world size all land here;
- ``stall``             inter-step wall gaps far beyond the step-time p95
                        with no event explaining them — data starvation,
                        checkpoint I/O, or eval, all "not training".

``goodput_pct`` = productive step seconds / total wall span.  The same
arithmetic backs the JAX package's post-hoc report
(``scripts/obs_report.py``) and the live ``GoodputTracker`` a trainer
registers under ``--goodput``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

BADPUT_KINDS = ("nan_skip", "rollback_discard", "preempt_gap", "recompile",
                "remesh", "stall")


@dataclasses.dataclass
class GoodputReport:
    wall_s: float
    productive_s: float
    badput_s: Dict[str, float]
    counts: Dict[str, int]
    steps: int
    # `alert` ft_events (obs/alerts.py) folded from the same stream.
    # Alerts are a symptom channel, not a badput class — the wall time
    # they describe is already booked by the kinds above.
    alerts: int = 0

    @property
    def goodput_pct(self) -> float:
        return 100.0 * self.productive_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def untracked_s(self) -> float:
        """Wall time neither productive nor attributed badput (host-side
        loop overhead, flushes, display)."""
        return max(0.0, self.wall_s - self.productive_s
                   - sum(self.badput_s.values()))


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def compute_goodput(records: List[dict], stall_factor: float = 5.0,
                    stall_min_s: float = 1.0) -> GoodputReport:
    """Fold a run's records (step + event, any order) into the ledger.

    ``stall_factor``/``stall_min_s``: an inter-step gap counts as a stall
    only when it exceeds both ``stall_factor`` x step-time p95 and the
    absolute floor — per-step jitter must not masquerade as starvation.
    """
    steps = sorted((r for r in records
                    if "step_time" in r and "ft_event" not in r
                    and "bench_event" not in r),
                   key=lambda r: r.get("t", 0.0))
    events = sorted((r for r in records if "ft_event" in r),
                    key=lambda r: r.get("t", 0.0))
    badput = {k: 0.0 for k in BADPUT_KINDS}
    counts = {k: 0 for k in BADPUT_KINDS}
    alerts = sum(1 for e in events if str(e["ft_event"]) == "alert")

    times = sorted(r["step_time"] for r in steps)
    median = _pct(times, 0.5)
    p95 = _pct(times, 0.95)

    by_step: Dict[int, dict] = {}
    for r in steps:
        if "step" in r:
            # keep the first occurrence: a re-trained step after rollback
            # appends a second record for the same index
            by_step.setdefault(int(r["step"]), r)

    productive = sum(r["step_time"] for r in steps)
    booked: set = set()  # step indices already moved out of productive

    for e in events:
        kind = str(e["ft_event"])
        if kind == "skip":
            counts["nan_skip"] += 1
            s = int(e.get("step", -1))
            rec = by_step.get(s)
            if rec is not None and s not in booked:
                booked.add(s)
                badput["nan_skip"] += rec["step_time"]
                productive -= rec["step_time"]
            elif rec is None:
                badput["nan_skip"] += median  # event without its record
        elif kind == "rollback":
            counts["rollback_discard"] += 1
            hi = int(e.get("step", -1))
            lo = int(e.get("restored_step", -1))
            for s in range(max(lo + 1, 0), hi + 1):
                rec = by_step.get(s)
                # a nan-skipped step in the window is already badput
                if rec is not None and s not in booked:
                    booked.add(s)
                    badput["rollback_discard"] += rec["step_time"]
                    productive -= rec["step_time"]
        elif kind == "preempt":
            counts["preempt_gap"] += 1
            t0 = e.get("t")
            nxt = [r["t"] for r in steps if r.get("t", 0.0) > (t0 or 0.0)]
            if t0 is not None and nxt:
                badput["preempt_gap"] += min(nxt) - t0
        elif kind == "recompile":
            counts["recompile"] += 1
            badput["recompile"] += float(e.get("duration_s", 0.0))
        elif kind == "remesh":
            # Like preempt: the cost is the gap between the membership
            # change and the first step on the rebuilt mesh (re-shard +
            # recompile at the new world size).
            counts["remesh"] += 1
            t0 = e.get("t")
            nxt = [r["t"] for r in steps if r.get("t", 0.0) > (t0 or 0.0)]
            if t0 is not None and nxt:
                badput["remesh"] += min(nxt) - t0

    # Stall scan: unexplained inter-step wall gaps.  Gaps that contain a
    # preemption or remesh event are already booked above.
    event_ts = [e.get("t", 0.0) for e in events
                if str(e["ft_event"]) in ("preempt", "remesh")]
    floor = max(stall_min_s, stall_factor * p95)
    for a, b in zip(steps, steps[1:]):
        if "t" not in a or "t" not in b:
            continue
        gap = b["t"] - a["t"]
        if gap <= floor:
            continue
        if any(a["t"] <= t <= b["t"] for t in event_ts):
            continue
        counts["stall"] += 1
        badput["stall"] += gap - b.get("step_time", 0.0)

    wall = 0.0
    ts = [r["t"] for r in records if "t" in r]
    if ts:
        first = min(ts)
        last = max(ts)
        # the first record's own step time happened before its timestamp
        wall = (last - first) + (steps[0].get("step_time", 0.0) if steps else 0.0)
    return GoodputReport(wall_s=wall, productive_s=max(0.0, productive),
                         badput_s=badput, counts=counts, steps=len(steps),
                         alerts=alerts)


def summarize_goodput(records: List[dict]) -> List[str]:
    """Human-readable ledger section for scripts/obs_report.py."""
    rep = compute_goodput(records)
    if rep.steps == 0 and not any(rep.counts.values()):
        return []
    lines = [
        "== goodput ==",
        f"  wall span         {rep.wall_s:.1f}s",
        f"  productive        {rep.productive_s:.1f}s",
        f"  goodput           {rep.goodput_pct:.1f}%",
    ]
    for kind in BADPUT_KINDS:
        if rep.counts[kind] or rep.badput_s[kind] > 0:
            lines.append(f"  badput/{kind:<17} {rep.badput_s[kind]:.1f}s "
                         f"({rep.counts[kind]}x)")
    if rep.untracked_s > 0.05 * rep.wall_s:
        lines.append(f"  untracked         {rep.untracked_s:.1f}s "
                     "(eval/ckpt/host overhead)")
    if rep.alerts:
        lines.append(f"  alerts fired      {rep.alerts} "
                     "(see the alerts section)")
    return lines


class GoodputTracker:
    """Live in-process ledger: registers as a MetricsLogger step sink
    (callable — invoked once per drained record) and reports at end of
    fit.  Bounded memory: keeps at most ``max_records`` records (a multi-
    day run folds the tail; the authoritative full-run number comes from
    ``obs_report`` over the JSONL)."""

    def __init__(self, max_records: int = 200_000):
        self.max_records = int(max_records)
        self.records: List[dict] = []
        self._dropped = 0

    def __call__(self, record: dict) -> None:
        if len(self.records) >= self.max_records:
            self._dropped += 1
            return
        self.records.append(dict(record))

    def report(self) -> GoodputReport:
        return compute_goodput(self.records)

    def format_summary(self) -> str:
        rep = self.report()
        bad = ", ".join(f"{k} {v:.1f}s" for k, v in rep.badput_s.items()
                        if v > 0) or "none"
        tail = f" ({self._dropped} records past cap untracked)" \
            if self._dropped else ""
        if rep.alerts:
            tail += f"; {rep.alerts} alert(s) fired"
        return (f"goodput {rep.goodput_pct:.1f}% over {rep.wall_s:.1f}s "
                f"({rep.steps} steps; badput: {bad}){tail}")
