"""Cross-rank clock alignment from heartbeats: the part of
``pytorch_distributed_tpu/obs/timeline.py`` that the postmortem uses
(``read_heartbeat_steps``, ``clock_offsets_from_heartbeats``), copied.

Stdlib only.  The rest of the JAX module (the XPlane parser, the
step-comm analysis and the Chrome-trace merge of per-rank captures) reads
XLA's profiler output; it waits for ROADMAP.md item A12's decision on its
torch meaning (a ``torch.profiler`` trace's NCCL kernels, with A13's comm
ledger).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict


def read_heartbeat_steps(hb_dir: str) -> Dict[int, Dict[int, float]]:
    """``{pid: {step: wall_time}}`` from every beat line in a heartbeat
    dir (unlike ``obs.heartbeat.read_heartbeats``, keeps the full per-step
    history — the alignment signal, not just liveness)."""
    out: Dict[int, Dict[int, float]] = {}
    for path in sorted(glob.glob(os.path.join(hb_dir, "heartbeat-*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    pid, step, t = int(rec["pid"]), int(rec["step"]), \
                        float(rec["t"])
                except (ValueError, KeyError):
                    continue  # torn tail
                out.setdefault(pid, {})[step] = t
    return out


def clock_offsets_from_heartbeats(hb_dir: str) -> Dict[int, float]:
    """Per-process clock offset (seconds) relative to the lowest pid.

    Ranks beat at the same step at (approximately) the same true time;
    the median per-common-step delta between a rank's beat wall-clock and
    the reference rank's estimates the skew between their captures.
    Subtracting the offset aligns the merged timeline."""
    beats = read_heartbeat_steps(hb_dir)
    if not beats:
        return {}
    ref_pid = min(beats)
    ref = beats[ref_pid]
    offsets = {ref_pid: 0.0}
    for pid, steps in beats.items():
        if pid == ref_pid:
            continue
        deltas = sorted(steps[s] - ref[s] for s in steps if s in ref)
        offsets[pid] = deltas[len(deltas) // 2] if deltas else 0.0
    return offsets
