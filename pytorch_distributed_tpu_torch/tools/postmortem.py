"""Cross-rank postmortem analyzer: merge per-rank flight-recorder dumps
(+ heartbeats) into a root-cause report for a hung or dead job.  The twin
of the JAX repo's ``scripts/postmortem.py`` (the same report, verdict and
exit codes) on the port's ``obs/flightrec.py`` and ``obs/timeline.py``; it
reads files only and touches no device.

Input is a directory of ``flightrec_rank<k>.json`` dumps written by
``obs/flightrec.py`` on any death path (signal, rollback, checkpoint
corruption, unhandled exception, or the collective-hang watchdog), plus —
when available — the run's heartbeat files, whose per-step wall-clock
history aligns the ranks' clocks (``obs/timeline.py``).

The report answers the questions that dominate multi-node debugging time:

- **which rank stalled first** (earliest aligned last-progress time —
  the rank that stopped completing steps before everyone else)
- **the desync frontier**: the last collective each rank entered, with
  kind/bytes/step — a rank sitting a step behind the others' frontier is
  the one everyone else is blocked waiting for
- **step skew** across ranks at death, and membership epoch agreement
- **per-rank memory at death** (an OOM-killed rank shows up as the one
  with the fat RSS and no hang event)

Usage:
    python -m pytorch_distributed_tpu_torch.tools.postmortem RUN_DIR [--hb-dir DIR] [--json]
    python -m pytorch_distributed_tpu_torch.tools.postmortem --selftest

Exit codes: 1 when a root cause is found (a hang event or a desynced
frontier), 0 for a clean set of dumps, 2 for none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from pytorch_distributed_tpu_torch.obs.flightrec import find_dumps
from pytorch_distributed_tpu_torch.obs.timeline import clock_offsets_from_heartbeats


# --------------------------------------------------------------- loading --

def load_dumps(flight_dir: str) -> Dict[int, Dict[str, Any]]:
    """``{rank: dump}`` for every parseable flightrec_rank<k>.json."""
    out: Dict[int, Dict[str, Any]] = {}
    for rank, path in find_dumps(flight_dir).items():
        try:
            with open(path) as f:
                out[rank] = json.load(f)
        except (OSError, ValueError):
            continue  # a torn/corrupt dump must not sink the others
    return out


# -------------------------------------------------------------- analysis --

def _last_event(events: List[Dict[str, Any]], kind: str,
                ) -> Optional[Dict[str, Any]]:
    for ev in reversed(events):
        if ev.get("kind") == kind:
            return ev
    return None


def analyze(dumps: Dict[int, Dict[str, Any]],
            offsets: Optional[Dict[int, float]] = None) -> Dict[str, Any]:
    """The merged root-cause report (pure function of the dumps).

    ``offsets`` maps *pid* → clock offset seconds (the heartbeat-derived
    alignment); each rank's timestamps are shifted by its pid's offset
    before any cross-rank comparison."""
    offsets = offsets or {}
    ranks: Dict[int, Dict[str, Any]] = {}
    for rank, d in sorted(dumps.items()):
        pid = d.get("pid")
        off = float(offsets.get(pid, 0.0))
        events = d.get("events") or []
        last_end = _last_event(events, "step_end")
        last_coll = _last_event(events, "coll_enter")
        hang = _last_event(events, "hang")
        in_step = d.get("in_step")
        # Last completed step: the final step_end wins; a rank mid-step
        # has progressed *through* step-1 only.
        last_step = last_end.get("step") if last_end else None
        if last_step is None and in_step:
            last_step = (in_step.get("step") or 0) - 1
        # Aligned time of the rank's last forward progress.
        progress_t = (last_end.get("t") if last_end
                      else (events[0].get("t") if events else None))
        frontier = None
        if last_coll is not None:
            frontier = {"step": last_coll.get("step"),
                        "kind": last_coll.get("collective"),
                        "bytes": last_coll.get("bytes")}
        elif d.get("last_collective"):
            lc = d["last_collective"]
            frontier = {"step": lc.get("step"), "kind": lc.get("kind"),
                        "bytes": lc.get("bytes")}
        membership = d.get("membership") or {}
        ranks[rank] = {
            "pid": pid,
            "reason": d.get("reason"),
            "clock_offset_s": off,
            "last_step": last_step,
            "last_progress_t": (None if progress_t is None
                                else progress_t - off),
            "in_step": in_step,
            "frontier": frontier,
            "hang": (None if hang is None else {
                "step": hang.get("step"),
                "t": (hang.get("t") or 0.0) - off,
                "elapsed_s": hang.get("elapsed_s"),
                "collective": hang.get("collective"),
            }),
            "epoch": membership.get("epoch"),
            "world": membership.get("world"),
            "mem_bytes": d.get("mem_bytes"),
            "events_dropped": d.get("events_dropped", 0),
        }

    report: Dict[str, Any] = {"ranks": ranks, "n_ranks": len(ranks)}
    if not ranks:
        report["verdict"] = "no flight dumps found"
        return report

    # Which rank stalled first: earliest aligned last-progress time.  In a
    # collective hang every rank eventually stops, but the culprit stops
    # completing steps first — the survivors block one collective later.
    with_t = {r: v["last_progress_t"] for r, v in ranks.items()
              if v["last_progress_t"] is not None}
    stalled = (min(with_t, key=with_t.get) if with_t
               else min(ranks))
    report["stalled_rank"] = stalled

    steps = [v["last_step"] for v in ranks.values()
             if v["last_step"] is not None]
    report["step_skew"] = (max(steps) - min(steps)) if steps else None

    fr_steps = {r: v["frontier"]["step"] for r, v in ranks.items()
                if v["frontier"] and v["frontier"].get("step") is not None}
    report["frontier_desync"] = (len(set(fr_steps.values())) > 1
                                 if fr_steps else False)
    # Behind-the-frontier beats raw progress time when the frontier itself
    # disagrees: the rank that never entered the collective everyone else
    # is blocked in is the root cause even if clocks are misaligned.
    if report["frontier_desync"]:
        report["stalled_rank"] = min(fr_steps, key=fr_steps.get)

    epochs = {v["epoch"] for v in ranks.values() if v["epoch"] is not None}
    report["epoch_skew"] = len(epochs) > 1
    report["epochs"] = sorted(epochs)

    hang_ranks = [r for r, v in ranks.items() if v["hang"] is not None]
    report["hang_ranks"] = hang_ranks

    culprit = ranks[report["stalled_rank"]]
    coll = culprit["frontier"] or {}
    report["verdict"] = (
        f"rank {report['stalled_rank']} stalled first "
        f"(last completed step {culprit['last_step']}, "
        f"last-entered collective "
        f"{coll.get('kind') or 'unknown'}@step {coll.get('step')})"
    )
    return report


def postmortem(flight_dir: str,
               hb_dir: Optional[str] = None) -> Dict[str, Any]:
    """Load dumps + heartbeat clock offsets and analyze.  ``hb_dir``
    defaults to the flight dir (trainers usually point both at the run
    directory); missing heartbeats degrade to zero offsets."""
    dumps = load_dumps(flight_dir)
    offsets: Dict[int, float] = {}
    try:
        offsets = clock_offsets_from_heartbeats(hb_dir or flight_dir)
    except Exception:
        pass
    return analyze(dumps, offsets)


# ------------------------------------------------------------- rendering --

def _fmt_mem(n: Optional[float]) -> str:
    if not n:
        return "-"
    return f"{n / (1 << 20):.0f}MiB"


def render_text(report: Dict[str, Any]) -> str:
    lines = ["== postmortem =="]
    if not report.get("ranks"):
        lines.append("  no flight dumps found")
        return "\n".join(lines)
    lines.append(f"  verdict: {report['verdict']}")
    if report.get("hang_ranks"):
        lines.append(f"  hang ft_events on ranks: "
                     f"{sorted(report['hang_ranks'])}")
    lines.append(
        f"  step skew {report.get('step_skew')}  "
        f"frontier desync {'YES' if report.get('frontier_desync') else 'no'}"
        f"  epoch skew "
        f"{'YES ' + str(report.get('epochs')) if report.get('epoch_skew') else 'no'}")
    for rank, v in sorted(report["ranks"].items()):
        fr = v.get("frontier") or {}
        hang = v.get("hang")
        mark = " <-- stalled first" if rank == report.get("stalled_rank") \
            else ""
        lines.append(
            f"  rank {rank} pid {v.get('pid')}: reason={v.get('reason')} "
            f"last_step={v.get('last_step')} "
            f"frontier={fr.get('kind') or '?'}@{fr.get('step')} "
            f"epoch={v.get('epoch')} mem={_fmt_mem(v.get('mem_bytes'))}"
            f"{' hang@step ' + str(hang['step']) if hang else ''}{mark}")
        if v.get("events_dropped"):
            lines.append(f"    ({v['events_dropped']} older events dropped "
                         f"from the ring)")
    return "\n".join(lines)


# --------------------------------------------------------------- fixture --

def make_fixture(out_dir: str) -> str:
    """Deterministic 2-rank hang fixture with a known desync frontier.

    Story: rank 1's clock runs 2 s ahead.  Both ranks complete steps 0-4;
    rank 0 enters the step-5 grad allreduce and blocks (its watchdog
    fires a hang); rank 1 stalled *before* entering step 5 — its frontier
    is the step-4 collective, one behind.  The analyzer must name rank 1
    via the frontier (and the aligned progress times agree).  Used by
    ``--selftest`` and checked in under ``tests/data/postmortem/``."""
    os.makedirs(out_dir, exist_ok=True)
    base = 1700000000.0
    skew = 2.0  # rank 1 wall clock = true time + 2 s

    def clean_events(rank: int, off: float):
        evs = []
        for s in range(5):  # steps 0..4 complete on both ranks
            t0 = base + 1.0 * s + off
            evs.append({"t": t0, "kind": "step_begin", "step": s})
            evs.append({"t": t0 + 0.1, "kind": "coll_enter", "step": s,
                        "collective": "all-reduce", "bytes": 4096.0})
            evs.append({"t": t0 + 0.8, "kind": "coll_exit", "step": s})
            evs.append({"t": t0 + 0.9, "kind": "step_end", "step": s,
                        "dt": 0.9})
        t5 = base + 5.0 + off
        if rank == 0:
            # enters the step-5 collective, never exits; watchdog fires
            evs.append({"t": t5, "kind": "step_begin", "step": 5})
            evs.append({"t": t5 + 0.1, "kind": "coll_enter", "step": 5,
                        "collective": "all-reduce", "bytes": 4096.0})
            evs.append({"t": t5 + 40.0, "kind": "hang", "step": 5,
                        "elapsed_s": 40.0, "threshold_s": 30.0,
                        "collective": "all-reduce"})
        else:
            # stalls before entering step 5: begins the step, no coll
            evs.append({"t": t5, "kind": "step_begin", "step": 5})
        return evs

    pids = {0: 11111, 1: 22222}
    for rank in (0, 1):
        off = skew if rank == 1 else 0.0
        events = clean_events(rank, off)
        last_coll_step = 5 if rank == 0 else 4
        dump = {
            "schema": 1,
            "rank": rank,
            "pid": pids[rank],
            "reason": "hang" if rank == 0 else "signal:15",
            "t_dump": base + 46.0 + off,
            "capacity": 2048,
            "events_total": len(events),
            "events_dropped": 0,
            "last_collective": {"step": last_coll_step,
                                "kind": "all-reduce", "bytes": 4096.0,
                                "name": "all-reduce.1",
                                "t": base + last_coll_step + 0.1 + off},
            "last_heartbeat": {"pid": pids[rank], "step": 4,
                               "t": base + 4.9 + off},
            "membership": {"world": 2, "epoch": 0},
            "in_step": {"step": 5,
                        "elapsed_s": 41.0 if rank == 0 else 43.0},
            "step_times": {"count": 5, "p50": 0.9, "p95": 0.9},
            "mem_bytes": (512 << 20) if rank == 0 else (768 << 20),
            "events": events,
        }
        with open(os.path.join(out_dir, f"flightrec_rank{rank}.json"),
                  "w") as f:
            json.dump(dump, f, indent=1)
            f.write("\n")
    # Heartbeat history for clock alignment: common steps 0..4, rank 1's
    # wall clock +2 s — clock_offsets_from_heartbeats recovers {22222: 2.0}.
    for rank in (0, 1):
        off = skew if rank == 1 else 0.0
        path = os.path.join(out_dir, f"heartbeat-{pids[rank]:05d}.jsonl")
        with open(path, "w") as f:
            for s in range(5):
                rec = {"pid": pids[rank], "step": s,
                       "t": base + 1.0 * s + 0.9 + off, "epoch": 0,
                       "world": 2}
                f.write(json.dumps(rec) + "\n")
    return out_dir


# -------------------------------------------------------------- selftest --

def _selftest() -> int:
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        make_fixture(td)
        report = postmortem(td)

        # 1. both ranks load
        assert report["n_ranks"] == 2, report

        # 2. clock alignment recovered rank 1's +2 s skew from heartbeats
        r1 = report["ranks"][1]
        assert abs(r1["clock_offset_s"] - 2.0) < 0.25, r1

        # 3. desync frontier: rank 0 entered all-reduce@5, rank 1 stopped
        #    at all-reduce@4 → frontier desync, rank 1 is the culprit
        assert report["frontier_desync"] is True, report
        assert report["ranks"][0]["frontier"]["step"] == 5
        assert report["ranks"][1]["frontier"]["step"] == 4
        assert report["stalled_rank"] == 1, report

        # 4. hang ft_event attributed (rank 0's watchdog fired while
        #    blocked waiting on rank 1)
        assert report["hang_ranks"] == [0], report
        assert report["ranks"][0]["hang"]["collective"] == "all-reduce"

        # 5. skew/epoch/memory forensics
        assert report["step_skew"] == 0, report  # both completed step 4
        assert report["epoch_skew"] is False and report["epochs"] == [0]
        assert report["ranks"][1]["mem_bytes"] == 768 << 20

        # 6. verdict names the rank and the collective; text render folds
        assert "rank 1 stalled first" in report["verdict"], report
        text = render_text(report)
        assert "== postmortem ==" in text and "<-- stalled first" in text

        # 7. empty dir degrades, not crashes
        with tempfile.TemporaryDirectory() as empty:
            r = postmortem(empty)
            assert r["n_ranks"] == 0 and "no flight dumps" in r["verdict"]

        # 8. json round-trip
        json.loads(json.dumps(report))

    print("postmortem selftest: OK (8 blocks)")
    return 0


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="merge per-rank flight-recorder dumps into a "
                    "cross-rank root-cause report")
    p.add_argument("flight_dir", nargs="?", default=None,
                   help="directory holding flightrec_rank<k>.json dumps "
                        "(the trainers' --flight-rec dir)")
    p.add_argument("--hb-dir", default=None,
                   help="heartbeat directory for cross-rank clock "
                        "alignment (default: the flight dir)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON instead of text")
    p.add_argument("--selftest", action="store_true",
                   help="run the no-mesh fixture selftest and exit")
    args = p.parse_args(argv)

    if args.selftest:
        return _selftest()
    if not args.flight_dir:
        p.error("flight_dir is required (or --selftest)")

    report = postmortem(args.flight_dir, hb_dir=args.hb_dir)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(render_text(report))
    # A found root cause exits 1 (forensic alarm, mirrors elastic_agent
    # status); an empty dir exits 2 so automation can tell them apart.
    if not report.get("ranks"):
        return 2
    return 1 if (report.get("hang_ranks")
                 or report.get("frontier_desync")) else 0


if __name__ == "__main__":
    sys.exit(main())
