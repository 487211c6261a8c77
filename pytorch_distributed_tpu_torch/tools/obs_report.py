"""Fold one run's observability artifacts into a human-readable summary,
or fence two runs against each other (``--diff A B``): the twin of the JAX
repo's ``scripts/obs_report.py``, every section and flag, on the same files.

    python -m pytorch_distributed_tpu_torch.tools.obs_report \
        --metrics-jsonl run.jsonl [--hb-dir DIR] [--flight-dir DIR] ...
    python -m pytorch_distributed_tpu_torch.tools.obs_report --diff A.jsonl B.jsonl
    python -m pytorch_distributed_tpu_torch.tools.obs_report --selftest

It reads with the port's ``obs/`` copies (``heartbeat``, ``reqtrace``,
``stepattr``, ``goodput``, ``alerts``) and folds flight dumps through
``tools/postmortem.py``, so it runs where JAX is not installed.  The comm
and memory ledgers and the autoplan payload have no producer in the port
yet; their files, as the JAX package writes them, are read here with a
reader of their JSON (``_load_comm_ledgers``).  One difference: the bench
staleness ages only the files ``--bench-lkg`` / ``--bench-events`` name
(the port's ``obs/alerts.py::bench_staleness``), never a checkout's own
``BENCH_LKG.json``, so the report does not depend on the day it runs.

Inputs (any subset):
- ``--metrics-jsonl``  per-step records from ``obs.MetricsLogger``
  (``--metrics-jsonl`` on any recipe / ``LMTrainer``);
- ``--hb-dir``         per-process heartbeats from ``obs.HeartbeatWriter``
  (``--hb-dir``), with straggler flagging by step lag / beat age;
- ``--telemetry-csv``  the 500 ms device-memory CSV from
  ``utils.telemetry.TelemetrySampler`` (``--telemetry-csv``);
- ``--flight-dir``     flight-recorder ring dumps (``--flight-rec`` on
  either trainer), folded in as the ``== postmortem ==`` cross-rank
  root-cause section (``tools/postmortem.py``);
- ``--synclint-json``  a synclint/shardlint ``--json`` capture, folded
  in as the ``== synclint ==`` cross-rank congruence section — the
  pre-launch twin of the postmortem fold.  With ``--strict``, any
  error-severity sync finding fails the report.

Output: step-time percentiles + throughput + MFU + loss/grad-norm
trajectory, the goodput/badput ledger (ft_event + recompile records),
bench staleness events, per-device peak HBM, and a straggler table —
with malformed JSONL lines *counted*, not silently skipped (the torn
final line after a SIGKILL is the common case).

``--diff A B`` compares two metrics JSONL files — step-time p50/p95,
throughput, MFU, goodput — and prints a thresholded PASS/REGRESS verdict
per metric (exit code 1 on overall REGRESS): the perf-regression fence a
CI job can gate on.  ``--strict`` additionally promotes the
bench-staleness WARN (``--bench-max-stale-days``) from a note to a
failing fence on both the report and the diff.

``--selftest`` synthesizes the artifacts in a temp dir, runs the report
and both diff verdicts on them, and asserts the output — the fast tier-1
CI hook.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple



def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _mib(n: float) -> str:
    return f"{n / (1024 * 1024):.1f}"


def load_metrics(path: str) -> Tuple[List[dict], int]:
    """Parse a metrics JSONL; returns ``(records, malformed_line_count)``.

    Malformed/truncated lines (the torn tail after a kill — routine since
    the FT subsystem made kill-and-resume a supported flow) are *counted*
    so the report can say how much of the stream was lost."""
    records, malformed = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                malformed += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                malformed += 1  # parseable but not a record object
    return records, malformed


def summarize_metrics(records: List[dict], malformed: int = 0) -> List[str]:
    if not records:
        return ["  (no records)"] + (
            [f"  malformed lines   {malformed}"] if malformed else [])
    records = sorted(records, key=lambda r: (r.get("step", 0), r.get("t", 0)))
    times = sorted(r["step_time"] for r in records if "step_time" in r)
    lines = [
        f"  steps logged      {len(records)} "
        f"(step {records[0].get('step')}..{records[-1].get('step')})",
        f"  wall span         {records[-1].get('t', 0) - records[0].get('t', 0):.1f}s",
        f"  step time         p50 {_pct(times, .5) * 1e3:.1f}ms  "
        f"p95 {_pct(times, .95) * 1e3:.1f}ms  "
        f"max {(times[-1] if times else 0) * 1e3:.1f}ms",
    ]
    if malformed:
        lines.append(f"  malformed lines   {malformed} "
                     "(torn tail from a killed writer?)")
    thr = [r["throughput"] for r in records if "throughput" in r]
    if thr:
        lines.append(f"  throughput        mean {sum(thr) / len(thr):.1f}/s  "
                     f"last {thr[-1]:.1f}/s")
    mfu = [r["mfu"] for r in records if "mfu" in r]
    if mfu:
        hfu = [r.get("hfu", 0.0) for r in records if "mfu" in r]
        lines.append(f"  mfu               mean {sum(mfu) / len(mfu):.1f}%  "
                     f"last {mfu[-1]:.1f}%  "
                     f"(hfu mean {sum(hfu) / len(hfu):.1f}%)")
    loss = [r["loss"] for r in records if "loss" in r]
    if loss:
        lines.append(f"  loss              first {loss[0]:.4f}  "
                     f"last {loss[-1]:.4f}")
    gn = [r["grad_norm"] for r in records if "grad_norm" in r]
    if gn:
        lines.append(f"  grad_norm         last {gn[-1]:.4f}  "
                     f"max {max(gn):.4f}")
    lr = [r["lr"] for r in records if "lr" in r]
    if lr:
        lines.append(f"  lr                last {lr[-1]:.6g}")
    return lines


def summarize_ft_events(records: List[dict]) -> List[str]:
    """Fold the FT subsystem's structured ``ft_event`` records (skips,
    rollbacks, preemptions — ft/divergence.py and the trainers) into the
    summary: per-kind counts with the steps involved, plus the final LR
    backoff scale after the last rollback."""
    events = [r for r in records if "ft_event" in r]
    if not events:
        return []
    by_kind: Dict[str, List[dict]] = {}
    for e in events:
        by_kind.setdefault(str(e["ft_event"]), []).append(e)
    lines = ["== ft events =="]
    for kind in sorted(by_kind):
        evs = by_kind[kind]
        steps = [e["step"] for e in evs if "step" in e]
        shown = ",".join(str(s) for s in steps[:8])
        if len(steps) > 8:
            shown += ",…"
        lines.append(f"  {kind:<16}  {len(evs)}x"
                     + (f"  steps {shown}" if steps else ""))
    rollbacks = by_kind.get("rollback", [])
    scales = [e["lr_scale"] for e in rollbacks if "lr_scale" in e]
    if scales:
        lines.append(f"  lr scale          {scales[-1]:g} after "
                     f"{len(rollbacks)} rollback(s)")
    return lines


def bench_staleness_info(args) -> Optional[Dict]:
    """Days-since-last-good from the ``--bench-lkg`` file and the
    ``--bench-events`` log (``obs/alerts.py::bench_staleness``, the copy of
    the JAX repo's ``benchlib``), honoring the report's fixed ``--now``
    clock.  None when neither artifact yields a timestamp or staleness
    reporting is disabled (``--bench-max-stale-days 0``)."""
    max_days = getattr(args, "bench_max_stale_days", None)
    if max_days is not None and max_days <= 0:
        return None
    from pytorch_distributed_tpu_torch.obs.alerts import bench_staleness

    info = bench_staleness(lkg_path=getattr(args, "bench_lkg", None),
                           events_path=getattr(args, "bench_events", None),
                           now=getattr(args, "now", None))
    if info is not None and max_days is not None:
        info["max_stale_days"] = max_days
        info["warn"] = info["days_stale"] > max_days
    return info


def summarize_bench(records: List[dict],
                    staleness: Optional[Dict] = None) -> List[str]:
    """Fold ``bench_event`` records (the JAX repo's benchlib — e.g. a stale
    benchmark probe replaying its last-known-good number) into the
    summary, so a dashboard reading this report can't mistake a replayed
    benchmark for a fresh one.  ``staleness`` (``bench_staleness_info``)
    adds the days-since-last-good aging line, with a WARN past
    ``--bench-max-stale-days``."""
    events = [r for r in records if "bench_event" in r]
    if not events and staleness is None:
        return []
    lines = ["== bench =="]
    for e in events:
        kind = str(e["bench_event"])
        detail = []
        if e.get("metric"):
            detail.append(str(e["metric"]))
        if e.get("last_good"):
            detail.append(f"last good {e['last_good']}")
        if e.get("reason"):
            detail.append(str(e["reason"]))
        lines.append(f"  {kind:<16}  " + "; ".join(detail))
    if staleness is not None:
        ev = (f", {staleness['stale_events']} stale event(s)"
              if staleness.get("stale_events") else "")
        lines.append(f"  last good         {staleness['days_stale']:.1f} "
                     f"days ago ({staleness.get('last_good')}){ev}")
        if staleness.get("predicted_mfu") is not None:
            meas = staleness.get("measured_mfu")
            drift = staleness.get("prediction_drift_pct")
            tail = (f"  measured {meas:.1f}%  drift {drift:+.1f}%"
                    if meas is not None and drift is not None else "")
            lines.append(f"  plan mfu          predicted "
                         f"{staleness['predicted_mfu']:.1f}%{tail}")
        if staleness.get("warn"):
            lines.append(f"  WARN              benchmark stale "
                         f"> {staleness['max_stale_days']:g} days — "
                         f"re-run bench.py for a fresh capture")
    return lines


# ------------------------------------------------------------- plan.json
def load_plan(path: str) -> Dict:
    """One autoplan sweep payload (the JAX repo's autoplan).  A multi-chip
    file ({"sweeps": [...]}) folds to its first sweep — the primary world
    size; pass a single-sweep file to report on another."""
    with open(path) as f:
        obj = json.load(f)
    if "sweeps" in obj:
        sweeps = obj["sweeps"]
        if not sweeps:
            raise ValueError(f"{path}: empty sweeps list")
        return sweeps[0]
    return obj


def plan_stats(payload: Dict) -> Optional[Dict]:
    """The chosen (top-ranked) plan's identity + predictions, or None for
    a sweep where nothing was feasible."""
    ranked = payload.get("ranked") or []
    if not ranked:
        return None
    top = ranked[0]
    pred = top.get("predicted", {})
    return {
        "model": payload.get("model"),
        "chips": payload.get("chips"),
        "hw": (payload.get("hw") or {}).get("name"),
        "key": top.get("plan", {}).get("key"),
        "cli": top.get("plan", {}).get("cli"),
        "predicted_mfu_pct": pred.get("mfu_pct"),
        "predicted_step_time_ms": pred.get("step_time_ms"),
        "predicted_wire_bytes": pred.get("wire_bytes"),
        "predicted_peak_hbm_bytes": pred.get("peak_hbm_bytes"),
        "validation_ok": payload.get("validation_ok"),
    }


def _residual(predicted: Optional[float],
              measured: Optional[float]) -> Optional[float]:
    if predicted is None or measured is None or not predicted:
        return None
    return 100.0 * (measured - predicted) / predicted


def summarize_plan(payload: Dict, records: List[dict]) -> List[str]:
    """The ``== plan ==`` section: the chosen plan + its predicted
    MFU/wire-bytes/peak-HBM, and — when a metrics stream is on hand —
    the measured values next to each prediction with the drift residual.
    Drift here is informational (the hard fences live in the validation
    pass autoplan --validate already ran against the lowered ledgers)."""
    ps = plan_stats(payload)
    lines = ["== plan =="]
    if ps is None:
        lines.append(f"  (no feasible plan for {payload.get('model')} "
                     f"at {payload.get('chips')} chips)")
        return lines
    lines.append(f"  chosen            {ps['key']}  "
                 f"({ps['model']} @ {ps['chips']} chips, {ps['hw']})")
    if ps["cli"]:
        lines.append(f"  cli               {ps['cli']}")
    cs = comm_stats(records)
    mfu = [r["mfu"] for r in records
           if "mfu" in r and "ft_event" not in r and "bench_event" not in r]
    measured_mfu = sum(mfu) / len(mfu) if mfu else None
    for label, pred, meas, fmt in (
            ("mfu", ps["predicted_mfu_pct"], measured_mfu,
             lambda v: f"{v:.1f}%"),
            ("wire bytes", ps["predicted_wire_bytes"],
             cs["comm_wire_bytes"], lambda v: f"{v:.0f} B"),
            ("peak hbm", ps["predicted_peak_hbm_bytes"],
             cs["peak_hbm_bytes"], lambda v: f"{_mib(v)} MiB")):
        if pred is None:
            continue
        res = _residual(pred, meas)
        tail = (f"  measured {fmt(meas)}  drift {res:+.1f}%"
                if res is not None else
                ("  measured --" if meas is None else ""))
        lines.append(f"  {label:<16}  predicted {fmt(pred)}{tail}")
    if ps["validation_ok"] is not None:
        lines.append("  validation        "
                     + ("ok (lowered-ledger fences hold)"
                        if ps["validation_ok"]
                        else "FAILED (predicted vs ledger fence exceeded)"))
    return lines


def plan_json_section(payload: Dict, records: List[dict]) -> Dict:
    """Machine-readable twin of ``summarize_plan``."""
    ps = plan_stats(payload)
    if ps is None:
        return {"model": payload.get("model"),
                "chips": payload.get("chips"), "chosen": None}
    cs = comm_stats(records)
    mfu = [r["mfu"] for r in records
           if "mfu" in r and "ft_event" not in r and "bench_event" not in r]
    measured_mfu = sum(mfu) / len(mfu) if mfu else None
    ps["measured_mfu_pct"] = measured_mfu
    ps["measured_wire_bytes"] = cs["comm_wire_bytes"]
    ps["measured_peak_hbm_bytes"] = cs["peak_hbm_bytes"]
    ps["mfu_drift_pct"] = _residual(ps["predicted_mfu_pct"], measured_mfu)
    ps["wire_drift_pct"] = _residual(ps["predicted_wire_bytes"],
                                     cs["comm_wire_bytes"])
    ps["peak_hbm_drift_pct"] = _residual(ps["predicted_peak_hbm_bytes"],
                                         cs["peak_hbm_bytes"])
    return ps


_COMM_FIELDS = ("model_comm_bytes", "comm_wire_bytes", "collective_count",
                "exposed_comm_ms", "overlap_pct", "peak_hbm_bytes")


def comm_stats(records: List[dict]) -> Dict[str, Optional[float]]:
    """Per-run means of the comm fields the trainers stamp from the static
    ledger (``model_comm_bytes``/``comm_wire_bytes``/``collective_count``,
    obs/comms.py) and the timeline analyzer measures
    (``exposed_comm_ms``/``overlap_pct``, obs/timeline.py)."""
    steps = [r for r in records
             if "ft_event" not in r and "bench_event" not in r]
    out: Dict[str, Optional[float]] = {}
    for key in _COMM_FIELDS:
        vals = [float(r[key]) for r in steps if key in r]
        out[key] = sum(vals) / len(vals) if vals else None
    return out


def comm_residual_pct(predicted: float, measured: float) -> float:
    """Relative prediction error in percent (against the measurement): the
    JAX ``obs/flops.py`` function."""
    if not measured:
        return 0.0 if not predicted else float("inf")
    return 100.0 * abs(predicted - measured) / measured


def _comm_residual(predicted: Optional[float],
                   measured: Optional[float]) -> Optional[float]:
    if predicted is None or measured is None or not predicted:
        return None
    return comm_residual_pct(predicted, measured)


class _CommLedger:
    """One step of a ``comm_ledger.json`` (the JAX ``obs/comms.py``
    ``CommLedger``'s reading side): its entries and their roll-ups."""

    def __init__(self, entries: List[dict]):
        self.entries = entries

    @property
    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries)

    @property
    def total_wire_bytes(self) -> float:
        return sum(e["wire_bytes"] for e in self.entries)

    @property
    def count(self) -> int:
        return len(self.entries)

    def _grouped(self, key: str) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for e in self.entries:
            slot = out.setdefault(
                e[key], {"count": 0, "bytes": 0, "wire_bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += e["bytes"]
            slot["wire_bytes"] += e["wire_bytes"]
        return out

    def by_kind(self) -> Dict[str, Dict[str, float]]:
        return self._grouped("kind")

    def by_phase(self) -> Dict[str, Dict[str, float]]:
        return self._grouped("phase")

    def phase_wire_encodings(self, phase: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            if e["phase"] == phase:
                enc = e.get("wire_encoding", "f32")
                out[enc] = out.get(enc, 0.0) + e["bytes"]
        return out


def _load_comm_ledgers(path: str) -> Dict[str, _CommLedger]:
    """``comm_ledger.json``: ``{step_name: ledger_dict}`` as the JAX
    ``obs/comms.py::write_ledgers`` writes it."""
    with open(path) as f:
        data = json.load(f)
    return {step: _CommLedger(list(d.get("entries", [])))
            for step, d in data.items()}


def summarize_comms(records: List[dict], ledger_path: Optional[str] = None,
                    predicted_bytes: Optional[float] = None) -> List[str]:
    """The ``== comms ==`` section: per-step collective traffic from the
    metrics stream, the itemized ledger breakdown when one is on disk, and
    the predicted-vs-measured residual fence (obs/flops.py analytic comm
    model vs the compiled ledger; >15% means the model and the lowering
    disagree about what the step communicates)."""
    cs = comm_stats(records)
    if not any(v is not None for v in cs.values()) and not ledger_path:
        return []
    lines = ["== comms =="]
    if cs["model_comm_bytes"] is not None:
        wire = (f", {cs['comm_wire_bytes']:.0f} B wire"
                if cs["comm_wire_bytes"] is not None else "")
        cnt = (f", {cs['collective_count']:.0f} collectives"
               if cs["collective_count"] is not None else "")
        lines.append(f"  per-step payload  {cs['model_comm_bytes']:.0f} B"
                     f"{wire}{cnt}")
    if cs["exposed_comm_ms"] is not None:
        ov = (f"  (overlap {cs['overlap_pct']:.1f}%)"
              if cs["overlap_pct"] is not None else "")
        lines.append(f"  exposed comm      "
                     f"{cs['exposed_comm_ms']:.3f} ms/step mean{ov}")
    residual = _comm_residual(predicted_bytes, cs["model_comm_bytes"])
    if residual is not None:
        verdict = "ok" if abs(residual) <= 15.0 else "EXCEEDS ±15%"
        lines.append(f"  predicted model   {predicted_bytes:.0f} B -> "
                     f"residual {residual:+.1f}% [{verdict}]")
    if ledger_path:
        for step, lg in sorted(_load_comm_ledgers(ledger_path).items()):
            kinds = ", ".join(
                f"{k}×{v['count']} {v['bytes']:.0f}B"
                for k, v in sorted(lg.by_kind().items()))
            lines.append(f"  ledger {step}: {kinds or 'no collectives'}")
            phases = ", ".join(
                f"{p} {v['bytes']:.0f}B"
                for p, v in sorted(lg.by_phase().items(),
                                   key=lambda kv: -kv[1]["bytes"]))
            if phases:
                lines.append(f"    by phase: {phases}")
            # grad_sync wire encodings: label compressed-collective traffic
            # by payload dtype (ops/qcomm.py modes) so an accidental f32
            # fallback is visible in the report, not just in shardlint.
            enc = lg.phase_wire_encodings("grad_sync")
            if enc and (len(enc) > 1 or "f32" not in enc):
                encs = ", ".join(f"{k} {v:.0f}B"
                                 for k, v in sorted(enc.items(),
                                                    key=lambda kv: -kv[1]))
                lines.append(f"    grad_sync encoding: {encs}")
    if len(lines) == 1:
        return []
    return lines


_MEM_FIELDS = ("mem_peak_bytes", "mem_temp_peak_bytes", "mem_residual_pct")


def mem_stats(records: List[dict]) -> Dict[str, Optional[float]]:
    """Per-run means of the memory-ledger fields the trainers stamp
    (``mem_peak_bytes``/``mem_temp_peak_bytes``/``mem_residual_pct``,
    obs/memory.py)."""
    steps = [r for r in records
             if "ft_event" not in r and "bench_event" not in r]
    out: Dict[str, Optional[float]] = {}
    for key in _MEM_FIELDS:
        vals = [float(r[key]) for r in steps if key in r]
        out[key] = sum(vals) / len(vals) if vals else None
    return out


def _load_mem_ledger_json(path: str) -> Dict[str, Dict]:
    """The raw ``mem_ledger.json`` dicts: unlike ``memory.load_ledgers``,
    the serialized ``class_peaks``/``phase_peaks`` stay authoritative —
    recomputing them from the truncated top-k buffer list would lie."""
    with open(path) as f:
        return json.load(f)


def summarize_memory(records: List[dict], ledger_path: Optional[str] = None,
                     top_k: int = 5) -> List[str]:
    """The ``== memory ==`` section: per-step peak HBM from the metrics
    stream, and — when a mem_ledger.json is on disk — the per-step
    watermark peak vs the compiled ``memory_analysis()`` ground truth
    (±10%% fence), the class/phase breakdown, and the top live buffers at
    the high-water mark."""
    ms = mem_stats(records)
    if not any(v is not None for v in ms.values()) and not ledger_path:
        return []
    lines = ["== memory =="]
    if ms["mem_peak_bytes"] is not None:
        temp = (f"  (temps {_mib(ms['mem_temp_peak_bytes'])} MiB)"
                if ms["mem_temp_peak_bytes"] is not None else "")
        lines.append(f"  per-step peak     {_mib(ms['mem_peak_bytes'])} MiB"
                     f"{temp}")
    if ms["mem_residual_pct"] is not None:
        verdict = ("ok" if ms["mem_residual_pct"] <= 10.0
                   else "EXCEEDS ±10%")
        lines.append(f"  vs memory_analysis residual "
                     f"{ms['mem_residual_pct']:.1f}% [{verdict}]")
    if ledger_path:
        for step, d in sorted(_load_mem_ledger_json(ledger_path).items()):
            peak = float(d.get("peak_bytes", 0))
            measured = float(d.get("measured_peak_bytes", 0.0))
            resid = float(d.get("residual_pct", 0.0))
            fence = ""
            if measured:
                verdict = "ok" if resid <= 10.0 else "EXCEEDS ±10%"
                fence = (f" (measured {_mib(measured)} MiB, residual "
                         f"{resid:.1f}% [{verdict}])")
            lines.append(f"  ledger {step}: peak {_mib(peak)} MiB at instr "
                         f"{d.get('peak_index')}/{d.get('n_instructions')}"
                         f"{fence}")
            classes = ", ".join(
                f"{k} {_mib(float(v))}"
                for k, v in sorted(d.get("class_peaks", {}).items(),
                                   key=lambda kv: -kv[1]) if v)
            if classes:
                lines.append(f"    by class (MiB): {classes}")
            phases = ", ".join(
                f"{p} {_mib(float(v))}"
                for p, v in sorted(d.get("phase_peaks", {}).items(),
                                   key=lambda kv: -kv[1]) if v)
            if phases:
                lines.append(f"    by phase (MiB): {phases}")
            for b in d.get("top", [])[:top_k]:
                dims = "x".join(str(x) for x in b.get("dims", [])) or "scalar"
                lines.append(
                    f"    top: {b.get('name'):<28} {_mib(b.get('bytes', 0))} "
                    f"MiB {b.get('dtype')}[{dims}] {b.get('klass')}"
                    + (f" ({b.get('phase')})" if b.get("phase") else ""))
    if len(lines) == 1:
        return []
    return lines


def telemetry_stats(path: str) -> Tuple[int, Dict[int, float], Dict[int, float]]:
    """``(n_rows, peak_by_device, limit_by_device)`` from the ``timestamp,
    index,bytes_limit,bytes_in_use,peak_bytes`` CSV (no header in the
    statistics.sh contract)."""
    peak: Dict[int, float] = {}
    limit: Dict[int, float] = {}
    n_rows = 0
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 5:
                continue
            try:
                idx = int(row[1])
                lim, pk = float(row[2]), float(row[4])
            except ValueError:
                continue  # header or torn row
            n_rows += 1
            peak[idx] = max(peak.get(idx, 0.0), pk)
            limit[idx] = max(limit.get(idx, 0.0), lim)
    return n_rows, peak, limit


def summarize_telemetry(path: str) -> List[str]:
    n_rows, peak, limit = telemetry_stats(path)
    if not peak:
        return ["  (no samples)"]
    lines = [f"  samples           {n_rows}"]
    for idx in sorted(peak):
        cap = f" / {_mib(limit[idx])} MiB" if limit[idx] else ""
        lines.append(f"  device {idx:<2}         peak {_mib(peak[idx])} MiB{cap}")
    return lines


def heartbeat_stats(hb_dir: str, now: Optional[float], max_step_lag: int,
                    max_age_s: float) -> Tuple[Dict, Dict, float]:
    """``(beats, flagged, now)`` — the parsed heartbeat state the text and
    JSON renderings share."""
    from pytorch_distributed_tpu_torch.obs.heartbeat import (
        find_stragglers,
        read_heartbeats,
    )

    beats = read_heartbeats(hb_dir)
    if now is None:
        now = time.time()
    flagged = find_stragglers(beats, now=now, max_step_lag=max_step_lag,
                              max_age_s=max_age_s) if beats else {}
    return beats, flagged, now


def read_membership(hb_dir: str) -> Optional[Dict]:
    """The elastic coordinator's membership.json, if this run is elastic
    (ft/elastic.py) — {"epoch": int, "ranks": [...]} or None."""
    path = os.path.join(hb_dir, "membership.json")
    try:
        with open(path) as f:
            obj = json.load(f)
        return {"epoch": int(obj["epoch"]),
                "ranks": [int(r) for r in obj["ranks"]]}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def summarize_heartbeats(hb_dir: str, now: Optional[float],
                         max_step_lag: int, max_age_s: float) -> List[str]:
    beats, flagged, now = heartbeat_stats(hb_dir, now, max_step_lag,
                                          max_age_s)
    if not beats:
        return ["  (no heartbeats)"]
    lines = []
    member = read_membership(hb_dir)
    if member is not None:
        lines.append(f"  membership epoch {member['epoch']}: "
                     f"world {len(member['ranks'])} "
                     f"ranks {member['ranks']}")
    for pid in sorted(beats):
        b = beats[pid]
        mark = f"  ** STRAGGLER: {flagged[pid]}" if pid in flagged else ""
        # hardened beats stamp their membership epoch (+ world) so a
        # stale incarnation is visibly from a pre-re-mesh world
        ep = f" epoch {b['epoch']}" if "epoch" in b else ""
        lines.append(f"  process {pid:<3}       step {b['step']:<8} "
                     f"beat age {now - b['t']:.1f}s{ep}{mark}")
    if not flagged:
        lines.append("  no stragglers")
    return lines


def _postmortem_mod():
    """The port's ``tools/postmortem.py``."""
    from pytorch_distributed_tpu_torch.tools import postmortem

    return postmortem


def postmortem_section(flight_dir: str,
                       hb_dir: Optional[str] = None) -> List[str]:
    """The ``== postmortem ==`` fold: merge per-rank flight-
    recorder dumps into the cross-rank root-cause report, clock-aligned
    against the heartbeats when available."""
    pm = _postmortem_mod()
    try:
        rep = pm.postmortem(flight_dir, hb_dir=hb_dir)
    except Exception as e:  # a torn dump must not kill the report
        return ["== postmortem ==", f"  (unreadable: {e})"]
    if not rep.get("n_ranks"):
        return ["== postmortem ==",
                f"  (no flightrec_rank*.json in '{flight_dir}')"]
    return pm.render_text(rep).splitlines()


def serving_stats(records: List[dict]) -> Optional[Dict]:
    """Scalar summary of the serving SLO fields (serving/engine.py):
    TTFT / inter-token-latency percentiles, queue/pool pressure,
    preemption and defrag counts.  None when the run logged no serving
    steps (training runs keep their report unchanged)."""
    steps = [r for r in records
             if r.get("serving") and "ft_event" not in r
             and "bench_event" not in r]
    if not steps:
        return None

    def last(field):
        # percentiles and counters are cumulative over the run — the
        # last stamped value IS the run summary
        for r in reversed(steps):
            v = r.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
        return None

    def peak(field):
        vals = [float(r[field]) for r in steps
                if isinstance(r.get(field), (int, float))]
        return max(vals) if vals else None

    out: Dict = {"steps": float(len(steps))}
    for f in ("ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms",
              "itl_p50_ms", "itl_p95_ms", "itl_p99_ms",
              "tokens_per_s", "requests_completed", "preemptions"):
        out[f] = last(f)
    out["queue_depth_peak"] = peak("queue_depth")
    out["kv_occupancy_peak_pct"] = peak("kv_occupancy_pct")
    out["kv_frag_peak_pct"] = peak("kv_frag_pct")
    out["defrags"] = float(sum(1 for r in records
                               if r.get("ft_event") == "serve_defrag"))
    # per-request attribution quantiles (obs/reqtrace.py step_fields):
    # stamped on serving step records when --req-trace is on; None keeps
    # untraced serving runs unchanged
    out["queue_wait_share_p99"] = last("queue_wait_share_p99")
    out["preempt_redo_ms_p99"] = last("preempt_redo_ms_p99")
    return out


def summarize_serving(records: List[dict]) -> List[str]:
    s = serving_stats(records)
    if s is None:
        return []

    def fmt(v, unit=""):
        return "--" if v is None else f"{v:.1f}{unit}"

    return [
        "== serving ==",
        f"  {s['steps']:.0f} serving step(s); "
        f"{fmt(s['requests_completed'])} request(s) completed; "
        f"{fmt(s['tokens_per_s'])} tok/s",
        f"  TTFT p50/p95/p99  {fmt(s['ttft_p50_ms'], 'ms')} / "
        f"{fmt(s['ttft_p95_ms'], 'ms')} / {fmt(s['ttft_p99_ms'], 'ms')}",
        f"  ITL p50/p95/p99   {fmt(s['itl_p50_ms'], 'ms')} / "
        f"{fmt(s['itl_p95_ms'], 'ms')} / {fmt(s['itl_p99_ms'], 'ms')}",
        f"  queue depth peak  {fmt(s['queue_depth_peak'])};  "
        f"KV occupancy peak {fmt(s['kv_occupancy_peak_pct'], '%')};  "
        f"frag peak {fmt(s['kv_frag_peak_pct'], '%')}",
        f"  preemptions       {fmt(s['preemptions'])};  "
        f"defrags {s['defrags']:.0f}",
    ]


def trace_stats(records: List[dict]) -> Optional[Dict]:
    """Attribution summary over the run's per-request ``reqtrace``
    events (obs/reqtrace.py); None when tracing was off."""
    from pytorch_distributed_tpu_torch.obs.reqtrace import (
        attribution_summary,
        trace_records,
    )

    return attribution_summary(trace_records(records))


def summarize_traces(records: List[dict]) -> List[str]:
    """The ``== traces ==`` fold: per-request TTFT/e2e
    critical-path attribution + the tail rollup that names the dominant
    component behind the p99."""
    s = trace_stats(records)
    if s is None:
        return []
    from pytorch_distributed_tpu_torch.obs.reqtrace import format_tail_line

    lines = [
        "== traces ==",
        f"  {s['requests']} request trace(s); {s['violations']} SLO "
        f"violation(s); {s['preemptions']} preemption(s); "
        f"spans kept {s['sampled_kept']}, dropped {s['spans_dropped']}",
        f"  TTFT p50/p99      {s['ttft_p50_ms']:.1f}ms / "
        f"{s['ttft_p99_ms']:.1f}ms;  e2e p99 {s['e2e_p99_ms']:.1f}ms;  "
        f"recon err max {s['recon_err_ms_max']:.3f}ms",
        f"  queue-wait share p99 {s['queue_wait_share_p99']:.1f}% of "
        f"TTFT;  preempt-redo p99 {s['preempt_redo_ms_p99']:.1f}ms",
    ]
    tail = s.get("tail")
    if tail:
        lines.append("  tail attribution: " + format_tail_line(tail))
        lines.append(f"  dominant tail component: {tail['dominant']}")
    return lines


def attr_stats(records: List[dict]) -> Optional[Dict]:
    """Step-time attribution summary over a ``--step-attr`` run's
    ``attr_*`` record fields (obs/stepattr.py), with the roofline bolted
    on when the run booked its ``stepattr_phases`` event.  None when
    attribution was off (every other run keeps its report unchanged)."""
    from pytorch_distributed_tpu_torch.obs import stepattr

    summ = stepattr.summarize(records)
    if summ is None:
        return None
    summ = dict(summ)
    ev = stepattr.phase_event(records)
    if ev is not None:
        summ["roofline"] = stepattr.roofline(summ, ev)
    return summ


def summarize_attribution(records: List[dict]) -> List[str]:
    """The ``== attribution ==`` fold: the exact identity
    step_time == compute + exposed_comm + host_sync + data_wait + other,
    the two diff-fenced tails, and the roofline's fix-first ranking."""
    s = attr_stats(records)
    if s is None:
        return []
    from pytorch_distributed_tpu_torch.obs.stepattr import format_summary_line

    lines = [
        "== attribution ==",
        "  " + format_summary_line(s),
        f"  identity recon    err max {s['recon_err_ms_max']:.3f}ms "
        f"({s['recon_err_pct_p50']:.2f}% of step p50) over "
        f"{s['steps']} step(s)",
        f"  data_wait_share   p50 {s['data_wait_share_p50']:.1f}%  "
        f"p95 {s['data_wait_share_p95']:.1f}%",
        f"  host_sync         p50 {s['host_sync_ms_p50']:.2f}ms  "
        f"p95 {s['host_sync_ms_p95']:.2f}ms",
    ]
    if s.get("overlap_measured") is not None:
        lines.append(f"  comm overlap      measured "
                     f"{s['overlap_measured']:.2f} "
                     f"(exposure source: {s['exposure_source']})")
    roof = s.get("roofline")
    if roof:
        lines.append("  fix first: " + ", ".join(
            f"{p['phase']} {p['headroom_ms']:.1f}ms ({p['label']})"
            for p in roof["fix_first"][:3]))
    return lines


_FLEET_COUNTERS = ("requests_routed", "requests_completed",
                   "requests_failed", "retries", "hedges", "hedges_won",
                   "hedges_lost", "duplicates_suppressed",
                   "replica_down_events", "drain_events",
                   "scale_up_events", "scale_down_events")

_FLEET_EVENT_KINDS = ("replica_down", "replica_evict", "scale_up",
                      "scale_down", "drain")


def fleet_stats(records: List[dict]) -> Optional[Dict]:
    """Scalar summary of the fleet router plane (serving/router.py):
    the ``fleet``-stamped cycle records carry the cumulative
    counters, the per-request ``fleettrace`` ft_events carry router-side
    latency attribution, and the ``replica_down`` / scale / drain
    ft_events carry the membership churn.  None when the run had no
    router (single-replica serving and training runs are untouched)."""
    steps = [r for r in records
             if r.get("fleet") and "ft_event" not in r
             and "bench_event" not in r]
    traces = [r for r in records if r.get("ft_event") == "fleettrace"]
    churn = [r for r in records
             if r.get("ft_event") in _FLEET_EVENT_KINDS]
    if not steps and not traces and not churn:
        return None

    def last(field):
        # counters are cumulative over the run — the last cycle record
        # stamped IS the run summary
        for r in reversed(steps):
            v = r.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
        return None

    out: Dict = {"cycles": float(len(steps))}
    for f in ("replicas_up", "replicas_quarantined", "replicas_total",
              "retry_rate_pct", "hedge_win_rate_pct"):
        out[f] = last(f)
    for f in _FLEET_COUNTERS:
        out[f] = last("fleet_" + f)
    out["traced_requests"] = float(len(traces))
    per: Dict[str, float] = {}
    for t in traces:
        k = str(t.get("replica"))
        per[k] = per.get(k, 0.0) + 1.0
    out["requests_by_replica"] = per
    if traces:
        def q99(field):
            vals = sorted(float(t.get(field, 0.0)) for t in traces)
            return _pct(vals, .99)

        out["router_ttft_p50_ms"] = _pct(
            sorted(float(t.get("router_ttft_ms", 0.0)) for t in traces), .5)
        out["router_ttft_p99_ms"] = q99("router_ttft_ms")
        out["router_wait_p99_ms"] = q99("router_wait_ms")
        out["redispatch_p99_ms"] = q99("redispatch_ms")
        out["hedge_wait_p99_ms"] = q99("hedge_wait_ms")
        out["engine_ttft_p99_ms"] = q99("engine_ttft_ms")
        out["retried_requests"] = float(
            sum(1 for t in traces if t.get("attempts", 1) > 1))
        out["hedged_requests"] = float(
            sum(1 for t in traces if t.get("hedged")))
    out["events"] = [
        {"kind": r.get("ft_event"), "replica": r.get("replica"),
         "reason": r.get("reason") or r.get("scope")}
        for r in churn]
    return out


def summarize_fleet(records: List[dict]) -> List[str]:
    """The ``== fleet ==`` fold: per-replica request counts,
    retries, hedges won/lost, drain/scale events, and the router-side
    tail attribution (router-wait vs redispatch vs engine)."""
    s = fleet_stats(records)
    if s is None:
        return []

    def fmt(v, unit=""):
        return "--" if v is None else f"{v:.1f}{unit}"

    def cnt(field):
        v = s.get(field)
        return "--" if v is None else f"{v:.0f}"

    lines = [
        "== fleet ==",
        f"  {s['cycles']:.0f} router cycle(s); replicas "
        f"{cnt('replicas_up')} up / {cnt('replicas_quarantined')} "
        f"quarantined / {cnt('replicas_total')} total",
        f"  routed {cnt('requests_routed')}; completed "
        f"{cnt('requests_completed')}; failed {cnt('requests_failed')}; "
        f"duplicates suppressed {cnt('duplicates_suppressed')}",
        f"  retries {cnt('retries')} (retry_rate "
        f"{fmt(s['retry_rate_pct'], '%')});  hedges {cnt('hedges')} "
        f"(won {cnt('hedges_won')} / lost {cnt('hedges_lost')}, win_rate "
        f"{fmt(s['hedge_win_rate_pct'], '%')})",
        f"  replica_down {cnt('replica_down_events')};  drain "
        f"{cnt('drain_events')};  scale up/down "
        f"{cnt('scale_up_events')}/{cnt('scale_down_events')}",
    ]
    if s["requests_by_replica"]:
        lines.append("  requests by replica: " + ", ".join(
            f"replica{k}×{v:.0f}"
            for k, v in sorted(s["requests_by_replica"].items())))
    if s.get("router_ttft_p99_ms") is not None:
        lines.append(
            f"  router TTFT p50/p99  "
            f"{fmt(s['router_ttft_p50_ms'], 'ms')} / "
            f"{fmt(s['router_ttft_p99_ms'], 'ms')};  "
            f"{s['traced_requests']:.0f} fleet trace(s), "
            f"{cnt('retried_requests')} retried, "
            f"{cnt('hedged_requests')} hedged")
        lines.append(
            f"  tail attribution p99: router_wait "
            f"{fmt(s['router_wait_p99_ms'], 'ms')}, redispatch "
            f"{fmt(s['redispatch_p99_ms'], 'ms')}, hedge_wait "
            f"{fmt(s['hedge_wait_p99_ms'], 'ms')}, engine "
            f"{fmt(s['engine_ttft_p99_ms'], 'ms')}")
    for e in s["events"]:
        what = f"  [{e['kind']}] replica={e['replica']}"
        if e.get("reason"):
            what += f" ({e['reason']})"
        lines.append(what)
    return lines


_SYNC_KINDS = ("collective-incongruence", "sync-digest-drift",
               "collective-desync", "protocol-desync")


def synclint_stats(path: str) -> Dict:
    """Roll up a synclint/shardlint ``--json`` report list: digest-pinned
    schedules, protocol verdicts, and every surviving sync finding."""
    try:
        with open(path) as f:
            reports = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return {"error": str(e)}
    digests = 0
    protocols_verified = 0
    by_kind: Dict[str, int] = {}
    findings: List[dict] = []
    for r in reports:
        if r.get("sync_digest"):
            digests += 1
        for f in r.get("findings", []):
            if f.get("kind") not in _SYNC_KINDS:
                continue
            if (f["kind"] == "protocol-desync"
                    and f.get("severity") == "info"):
                protocols_verified += 1
                continue
            by_kind[f["kind"]] = by_kind.get(f["kind"], 0) + 1
            findings.append(f)
    return {
        "schedules_pinned": digests,
        "protocols_verified": protocols_verified,
        "errors": sum(1 for f in findings if f.get("severity") == "error"),
        "warnings": sum(1 for f in findings if f.get("severity") == "warn"),
        "by_kind": by_kind,
        "findings": findings,
    }


def summarize_synclint(path: str) -> List[str]:
    """The ``== synclint ==`` fold: cross-rank congruence verdicts from a
    synclint/shardlint --json capture.  Errors here are the pre-launch
    twin of the postmortem section's hang diagnosis."""
    s = synclint_stats(path)
    lines = ["== synclint =="]
    if "error" in s:
        lines.append(f"  (unreadable: {s['error']})")
        return lines
    lines.append(f"  {s['schedules_pinned']} collective schedule(s) "
                 f"digest-verified; {s['protocols_verified']} protocol(s) "
                 "model-checked desync-free")
    if not s["findings"]:
        lines.append("  congruence clean: no desync findings")
    else:
        lines.append(f"  {s['errors']} error(s), {s['warnings']} warn(s): "
                     + ", ".join(f"{k}×{v}"
                                 for k, v in sorted(s["by_kind"].items())))
        for f in s["findings"]:
            lines.append(f"  [{f.get('severity')}] {f.get('kind')} @ "
                         f"{f.get('where')}: {f.get('message')}")
    return lines


def report(args) -> str:
    sections = []
    records: List[dict] = []
    if args.metrics_jsonl:
        records, malformed = load_metrics(args.metrics_jsonl)
        sections.append("== steps ==")
        sections += summarize_metrics(
            [r for r in records
             if "ft_event" not in r and "bench_event" not in r], malformed)
        sections += summarize_ft_events(records)
        from pytorch_distributed_tpu_torch.obs.alerts import summarize_alerts
        from pytorch_distributed_tpu_torch.obs.goodput import summarize_goodput

        sections += summarize_goodput(records)
        sections += summarize_alerts(records)
        sections += summarize_comms(records, getattr(args, "comm_ledger", None),
                                    getattr(args, "comm_predicted", None))
        sections += summarize_memory(records,
                                     getattr(args, "mem_ledger", None))
        sections += summarize_bench(records, bench_staleness_info(args))
        sections += summarize_serving(records)
        sections += summarize_traces(records)
        sections += summarize_fleet(records)
        sections += summarize_attribution(records)
    else:
        if getattr(args, "comm_ledger", None):
            sections += summarize_comms([], args.comm_ledger,
                                        getattr(args, "comm_predicted", None))
        if getattr(args, "mem_ledger", None):
            sections += summarize_memory([], args.mem_ledger)
    if getattr(args, "plan", None):
        sections += summarize_plan(load_plan(args.plan), records)
    if args.telemetry_csv:
        sections.append("== devices ==")
        sections += summarize_telemetry(args.telemetry_csv)
    if args.hb_dir:
        sections.append("== heartbeats ==")
        sections += summarize_heartbeats(args.hb_dir, args.now,
                                         args.max_step_lag, args.max_beat_age)
    if getattr(args, "synclint_json", None):
        sections += summarize_synclint(args.synclint_json)
    if getattr(args, "flight_dir", None):
        sections += postmortem_section(args.flight_dir,
                                       getattr(args, "hb_dir", None))
    if not sections:
        sections.append("nothing to report: pass --metrics-jsonl, "
                        "--hb-dir, and/or --telemetry-csv")
    return "\n".join(sections)


def report_json(args) -> Dict:
    """Machine-readable twin of ``report()``: every section as structured
    data (``--format json``)."""
    out: Dict = {}
    records: List[dict] = []
    if args.metrics_jsonl:
        records, malformed = load_metrics(args.metrics_jsonl)
        steps = [r for r in records
                 if "ft_event" not in r and "bench_event" not in r]
        stats = run_stats(records)
        stats["malformed_lines"] = malformed
        loss = [r["loss"] for r in steps if "loss" in r]
        if loss:
            stats["loss_first"], stats["loss_last"] = loss[0], loss[-1]
        out["steps"] = stats
        events: Dict[str, Dict] = {}
        for e in (r for r in records if "ft_event" in r):
            slot = events.setdefault(str(e["ft_event"]),
                                     {"count": 0, "steps": []})
            slot["count"] += 1
            if "step" in e:
                slot["steps"].append(e["step"])
        out["ft_events"] = events
        from pytorch_distributed_tpu_torch.obs.goodput import compute_goodput

        gp = compute_goodput(records)
        out["goodput"] = {
            "wall_s": gp.wall_s, "productive_s": gp.productive_s,
            "badput_s": dict(gp.badput_s), "counts": dict(gp.counts),
            "steps": gp.steps, "goodput_pct": gp.goodput_pct,
            "untracked_s": gp.untracked_s, "alerts": gp.alerts,
        }
        from pytorch_distributed_tpu_torch.obs.alerts import alerts_data

        out["alerts"] = alerts_data(records)
        out["bench"] = [r for r in records if "bench_event" in r]
        comms = comm_stats(records)
        comms["residual_pct"] = _comm_residual(
            getattr(args, "comm_predicted", None),
            comms["model_comm_bytes"])
        comms["predicted_bytes"] = getattr(args, "comm_predicted", None)
        out["comms"] = comms
        out["memory"] = mem_stats(records)
        srv = serving_stats(records)
        if srv is not None:
            out["serving"] = srv
        trc = trace_stats(records)
        if trc is not None:
            out["traces"] = trc
        flt = fleet_stats(records)
        if flt is not None:
            out["fleet"] = flt
        att = attr_stats(records)
        if att is not None:
            out["attribution"] = att
    staleness = bench_staleness_info(args)
    if staleness is not None:
        out["bench_staleness"] = staleness
    if getattr(args, "comm_ledger", None):
        out.setdefault("comms", {})["ledger"] = {
            step: {"total_bytes": lg.total_bytes,
                   "total_wire_bytes": lg.total_wire_bytes,
                   "count": lg.count, "by_kind": lg.by_kind(),
                   "by_phase": lg.by_phase()}
            for step, lg in _load_comm_ledgers(args.comm_ledger).items()}
    if getattr(args, "mem_ledger", None):
        out.setdefault("memory", {})["ledger"] = _load_mem_ledger_json(
            args.mem_ledger)
    if getattr(args, "plan", None):
        out["plan"] = plan_json_section(load_plan(args.plan), records)
    if args.telemetry_csv:
        n_rows, peak, limit = telemetry_stats(args.telemetry_csv)
        out["devices"] = {
            "samples": n_rows,
            "per_device": {str(i): {"peak_bytes": peak[i],
                                    "limit_bytes": limit.get(i, 0.0)}
                           for i in sorted(peak)},
        }
    if args.hb_dir:
        beats, flagged, now = heartbeat_stats(
            args.hb_dir, args.now, args.max_step_lag, args.max_beat_age)
        out["heartbeats"] = {
            str(pid): {"step": b.get("step"), "beat_age_s": now - b["t"],
                       "epoch": b.get("epoch"),
                       "straggler": flagged.get(pid)}
            for pid, b in sorted(beats.items())}
        member = read_membership(args.hb_dir)
        if member is not None:
            out["membership"] = member
    if getattr(args, "synclint_json", None):
        out["synclint"] = synclint_stats(args.synclint_json)
    if getattr(args, "flight_dir", None):
        try:
            out["postmortem"] = _postmortem_mod().postmortem(
                args.flight_dir, hb_dir=getattr(args, "hb_dir", None))
        except Exception as e:
            out["postmortem"] = {"error": str(e)}
    return out


# ------------------------------------------------------------------ run diff
def run_stats(records: List[dict]) -> Dict[str, Optional[float]]:
    """Scalar per-run summary for the diff fence."""
    from pytorch_distributed_tpu_torch.obs.goodput import compute_goodput

    steps = [r for r in records
             if "step_time" in r and "ft_event" not in r
             and "bench_event" not in r]
    times = sorted(r["step_time"] for r in steps)
    thr = [r["throughput"] for r in steps if "throughput" in r]
    mfu = [r["mfu"] for r in steps if "mfu" in r]
    from pytorch_distributed_tpu_torch.obs import stepattr as stepattr_mod

    gp = compute_goodput(records)
    cs = comm_stats(records)
    srv = serving_stats(records)
    trc = trace_stats(records)
    flt = fleet_stats(records)
    att_s = stepattr_mod.summarize(records)

    def attr(field):
        # prefer the step-record stamp (windowed, what the run saw live);
        # fall back to the reqtrace events so a trace-only JSONL still
        # fences — None when neither plane was on
        v = srv.get(field) if srv else None
        if v is None and trc is not None:
            v = trc.get(field)
        return v

    return {
        "steps": float(len(steps)),
        "step_time_p50": _pct(times, .5) if times else None,
        "step_time_p95": _pct(times, .95) if times else None,
        "throughput": sum(thr) / len(thr) if thr else None,
        "mfu": sum(mfu) / len(mfu) if mfu else None,
        "goodput": gp.goodput_pct if gp.steps else None,
        "badput_remesh_s": gp.badput_s["remesh"] if gp.steps else None,
        "model_comm_bytes": cs["model_comm_bytes"],
        "comm_wire_bytes": cs["comm_wire_bytes"],
        "exposed_comm_ms": cs["exposed_comm_ms"],
        "peak_hbm_bytes": cs["peak_hbm_bytes"],
        "alerts": float(gp.alerts) if gp.steps else None,
        # serving SLO fences (None for training runs -> rows skip)
        "ttft_p99_ms": srv["ttft_p99_ms"] if srv else None,
        "tokens_per_s": srv["tokens_per_s"] if srv else None,
        # per-request attribution fences (--req-trace runs only)
        "queue_wait_share_p99": attr("queue_wait_share_p99"),
        "preempt_redo_ms_p99": attr("preempt_redo_ms_p99"),
        # fleet router fences (serving/router.py) — None without a
        # router, so single-replica and training diffs are untouched
        "retry_rate": flt["retry_rate_pct"] if flt else None,
        "hedge_win_rate": flt["hedge_win_rate_pct"] if flt else None,
        # step-attribution fences (obs/stepattr.py) — None without
        # --step-attr, so unattributed diffs are untouched
        "data_wait_share_p95": (att_s["data_wait_share_p95"]
                                if att_s else None),
        "host_sync_ms_p95": (att_s["host_sync_ms_p95"]
                             if att_s else None),
    }


# (name, lower_is_better, absolute) — goodput diffs in absolute
# percentage points and badput_remesh_s in absolute seconds (both use
# goodput_threshold_pp: a remesh storm is seconds of lost wall clock,
# not a ratio — an elastic drill vs its uninterrupted baseline divides
# by zero otherwise); the rest diff in relative percent.
# exposed_comm_ms fences the overlap win (more un-overlapped collective
# time per step); wire bytes fence the traffic itself (a sharding change
# that moves more data); peak_hbm_bytes fences the compiled per-device
# footprint (the --zero wus / fused-CE memory wins, stamped from the
# ledger's memory_analysis).
_DIFF_METRICS = (
    ("step_time_p50", True, False),
    ("step_time_p95", True, False),
    ("throughput", False, False),
    ("mfu", False, False),
    ("goodput", False, True),
    ("badput_remesh_s", True, True),
    ("exposed_comm_ms", True, False),
    ("comm_wire_bytes", True, False),
    ("peak_hbm_bytes", True, False),
    # `alert` ft_event count (obs/alerts.py): absolute delta — any NEW
    # alert in the candidate regresses (threshold 0.5 below), and a
    # clean baseline (0 alerts) must not divide-by-zero.
    ("alerts", True, True),
    # serving SLO fences (serving/engine.py): time-to-first-token p99
    # and end-to-end token throughput.  Missing from training runs ->
    # both rows skip, so training diffs are untouched.
    ("ttft_p99_ms", True, False),
    ("tokens_per_s", False, False),
    # per-request attribution fences (obs/reqtrace.py): both absolute —
    # the share is percentage points, and a clean baseline books
    # preempt_redo_ms_p99 == 0 so a relative row would hide a planted
    # preemption storm behind the zero-baseline guard.
    ("queue_wait_share_p99", True, True),
    ("preempt_redo_ms_p99", True, True),
    # fleet router fences (serving/router.py): both absolute percentage
    # points — retry_rate climbing means replicas are flapping under the
    # candidate; hedge_win_rate falling means the hedge delay stopped
    # tracking the real p95 (hedges fire but never win).  A clean
    # baseline books 0% retries, so relative rows would divide by zero.
    ("retry_rate", True, True),
    ("hedge_win_rate", False, True),
    # step-attribution fences (obs/stepattr.py, --step-attr): both
    # absolute — the share is percentage points, and a clean baseline
    # books host_sync_ms_p95 near zero so a relative row would hide a
    # planted host-sync regression behind the zero-baseline guard.
    # These catch composition regressions that the aggregate step-time
    # row can mask: a loader that got slower while compute got faster.
    ("data_wait_share_p95", True, True),
    ("host_sync_ms_p95", True, True),
)


def diff_data(a_records: List[dict], b_records: List[dict],
              threshold_pct: float = 10.0,
              goodput_threshold_pp: float = 5.0,
              label_a: str = "A", label_b: str = "B") -> Dict:
    """Compare run B against baseline run A -> structured verdicts.

    A metric REGRESSes when B is worse than A by more than
    ``threshold_pct`` percent (relative), or ``goodput_threshold_pp``
    percentage points for the absolute-pp metrics.  Metrics missing from
    either run are skipped — a run without ``--mfu`` must not fail the
    fence on MFU."""
    sa, sb = run_stats(a_records), run_stats(b_records)
    rows: List[Dict] = []
    regressed = False
    for name, lower_better, absolute_pp in _DIFF_METRICS:
        va, vb = sa[name], sb[name]
        row: Dict = {"metric": name, "a": va, "b": vb}
        if va is None or vb is None:
            row["verdict"] = "missing"
        elif absolute_pp:
            delta = vb - va
            row["delta_pp"] = delta
            # alerts: any new firing is a regression, not a ±5pp band
            thr = 0.5 if name == "alerts" else goodput_threshold_pp
            worse = (delta > thr if lower_better else -delta > thr)
            row["verdict"] = "REGRESS" if worse else "PASS"
            regressed = regressed or worse
        elif va == 0:
            row["verdict"] = "zero-baseline"
        else:
            row["delta_pct"] = 100.0 * (vb - va) / va
            worse = (row["delta_pct"] > threshold_pct if lower_better
                     else row["delta_pct"] < -threshold_pct)
            row["verdict"] = "REGRESS" if worse else "PASS"
            regressed = regressed or worse
        rows.append(row)
    return {
        "baseline": label_a, "candidate": label_b,
        "steps_a": sa["steps"], "steps_b": sb["steps"],
        "metrics": rows,
        "overall": "REGRESS" if regressed else "PASS",
        "regressed": regressed,
    }


def diff_report(a_records: List[dict], b_records: List[dict],
                threshold_pct: float = 10.0,
                goodput_threshold_pp: float = 5.0,
                label_a: str = "A", label_b: str = "B") -> Tuple[str, bool]:
    """Text rendering of ``diff_data`` → (report text, regressed)."""
    d = diff_data(a_records, b_records, threshold_pct=threshold_pct,
                  goodput_threshold_pp=goodput_threshold_pp,
                  label_a=label_a, label_b=label_b)
    w = 20
    lines = [
        "== diff ==",
        f"  baseline {d['baseline']}: {d['steps_a']:.0f} steps;  "
        f"candidate {d['candidate']}: {d['steps_b']:.0f} steps",
        f"  {'metric':<{w}} {'A':>10} {'B':>10} {'delta':>9}  verdict",
    ]
    for row in d["metrics"]:
        name, va, vb = row["metric"], row["a"], row["b"]
        if row["verdict"] == "missing":
            lines.append(f"  {name:<{w}} {'--':>10} {'--':>10} {'--':>9}  "
                         "(missing)")
            continue
        if row["verdict"] == "zero-baseline":
            lines.append(f"  {name:<{w}} {va:>10.4g} {vb:>10.4g} "
                         f"{'--':>9}  (zero baseline)")
            continue
        if "delta_pp" in row:
            if name == "alerts":  # a count, not a percentage
                dtxt = f"{row['delta_pp']:+.0f}"
                fa, fb = f"{va:.0f}", f"{vb:.0f}"
            elif name.endswith(("_ms", "_ms_p99", "_ms_p95")):
                # absolute but milliseconds (preempt_redo_ms_p99,
                # host_sync_ms_p95)
                dtxt = f"{row['delta_pp']:+.1f}ms"
                fa, fb = f"{va:.1f}ms", f"{vb:.1f}ms"
            else:
                dtxt = f"{row['delta_pp']:+.1f}pp"
                fa, fb = f"{va:.1f}%", f"{vb:.1f}%"
        else:
            dtxt = f"{row['delta_pct']:+.1f}%"
            if name.startswith("step_time"):
                fa, fb = f"{va * 1e3:.1f}ms", f"{vb * 1e3:.1f}ms"
            else:
                fa, fb = f"{va:.4g}", f"{vb:.4g}"
        lines.append(f"  {name:<{w}} {fa:>10} {fb:>10} {dtxt:>9}  "
                     f"{row['verdict']}")
    lines.append(f"overall: {d['overall']}")
    return "\n".join(lines), d["regressed"]


def plan_diff_rows(plan: Optional[Dict], a_records: List[dict],
                   b_records: List[dict]) -> Tuple[List[str], Dict]:
    """The predicted-vs-measured residual rows a ``--plan`` adds to the
    diff: how far each run's measured MFU sits from the planner's
    prediction.  Like bench staleness, a note — prediction drift means
    the cost model needs recalibrating, not that run B regressed."""
    if plan is None:
        return [], {}
    ps = plan_stats(plan)
    if ps is None or ps.get("predicted_mfu_pct") is None:
        return [], {}
    sa, sb = run_stats(a_records), run_stats(b_records)
    pred = ps["predicted_mfu_pct"]
    drift = {"predicted_mfu_pct": pred, "plan_key": ps["key"],
             "mfu_drift_a_pct": _residual(pred, sa["mfu"]),
             "mfu_drift_b_pct": _residual(pred, sb["mfu"])}
    fa = (f"{drift['mfu_drift_a_pct']:+.1f}%"
          if drift["mfu_drift_a_pct"] is not None else "--")
    fb = (f"{drift['mfu_drift_b_pct']:+.1f}%"
          if drift["mfu_drift_b_pct"] is not None else "--")
    lines = [f"  {'plan_mfu_drift':<16} {fa:>10} {fb:>10} "
             f"{'--':>9}  (vs predicted {pred:.1f}%, plan {ps['key']}; "
             "note, not a fence)"]
    return lines, drift


def run_diff(path_a: str, path_b: str, threshold_pct: float,
             goodput_threshold_pp: float, fmt: str = "text",
             staleness: Optional[Dict] = None,
             plan: Optional[Dict] = None,
             strict: bool = False) -> int:
    a, mal_a = load_metrics(path_a)
    b, mal_b = load_metrics(path_b)
    kw = dict(threshold_pct=threshold_pct,
              goodput_threshold_pp=goodput_threshold_pp,
              label_a=os.path.basename(path_a),
              label_b=os.path.basename(path_b))
    plan_lines, plan_drift = plan_diff_rows(plan, a, b)
    stale_fail = bool(strict and staleness is not None
                      and staleness.get("warn"))
    if fmt == "json":
        d = diff_data(a, b, **kw)
        d["malformed_lines"] = {"a": mal_a, "b": mal_b}
        if staleness is not None:
            d["bench_staleness"] = staleness
        if stale_fail:
            d["stale_fence_failed"] = True
        if plan_drift:
            d["plan"] = plan_drift
        print(json.dumps(d, indent=2))
        return 1 if (d["regressed"] or stale_fail) else 0
    text, regressed = diff_report(a, b, **kw)
    if plan_lines:
        # splice the drift row above the overall verdict line
        body = text.splitlines()
        text = "\n".join(body[:-1] + plan_lines + body[-1:])
    if mal_a or mal_b:
        text += f"\n(malformed lines: A {mal_a}, B {mal_b})"
    if staleness is not None and staleness.get("warn"):
        # By default a note, never a verdict: a stale benchmark capture
        # makes the comparison context-poor but does not make run B a
        # regression.  --strict promotes it to a failing fence (the CI
        # posture: refuse to certify a diff against unrefreshed numbers).
        kind = "STRICT" if strict else "note"
        text += (f"\n{kind}: benchmark baseline stale "
                 f"{staleness['days_stale']:.1f} days "
                 f"(> {staleness['max_stale_days']:g}) — re-run bench.py")
    print(text)
    return 1 if (regressed or stale_fail) else 0


def _selftest() -> int:
    """Synthesize the artifacts, run the report + diff fences, assert."""
    import tempfile

    from pytorch_distributed_tpu_torch.obs import HeartbeatWriter, MetricsLogger

    with tempfile.TemporaryDirectory() as d:
        now = time.time()
        # per-step metrics via the real logger
        mpath = os.path.join(d, "metrics.jsonl")
        with MetricsLogger(mpath, flush_every=7) as log:
            for i in range(20):
                log.log_step(i, step_time=0.01 + 0.001 * (i % 5),
                             n_items=128, lr=0.1,
                             scalars={"loss": 2.0 - 0.05 * i,
                                      "grad_norm": 1.0 + 0.1 * i},
                             extra={"mfu": 40.0 + 0.1 * i,
                                    "hfu": 45.0 + 0.1 * i,
                                    "model_comm_bytes": 66952.0,
                                    "comm_wire_bytes": 100428.0,
                                    "collective_count": 16.0,
                                    "exposed_comm_ms": 0.40,
                                    "overlap_pct": 33.3,
                                    "mem_peak_bytes": 820.0,
                                    "mem_temp_peak_bytes": 120.0,
                                    "mem_residual_pct": 2.5})
            # ft_event records interleave in the same JSONL (ft/)
            log.log_event("skip", step=7, consecutive=1)
            log.log_event("skip", step=8, consecutive=2)
            log.log_event("rollback", step=9, restored_step=5, lr_scale=0.5)
            log.log_event("remesh", step=12, change="shrink", old_world=4,
                          new_world=3, epoch=1, reason="drill")
            log.log_event("preempt", step=19)
            # live alert plane (obs/alerts.py): firings booked as
            # `alert` ft_events fold into their own report section
            log.log_event("alert", step=15, alert="step_time_p95",
                          rule="step_time_p95", severity="warn",
                          value=22.0, threshold=15.0, rank=0,
                          detail="step time p95 22.0ms > 15ms")
            log.log_event("alert", step=18, alert="dead_rank",
                          rule="dead_rank", severity="page", rank=1,
                          detail="rank 1: beat age 120.0s > 60s "
                                 "(dead or hung)")
        with open(mpath, "a") as f:
            # torn tail (a killed writer) + a bench staleness event
            f.write(json.dumps({
                "bench_event": "stale", "t": now,
                "metric": "resnet50_train_images_per_sec_per_chip",
                "last_good": "2026-07-31T06:32:08+0000",
                "reason": "device discovery hung (tunnel unreachable)",
            }) + "\n")
            f.write('{"step": 20, "step_time": 0.0')
        # heartbeats: pid 0 current (elastic, epoch-stamped), pid 1
        # lagging AND stale; membership.json as the coordinator leaves it
        hb_dir = os.path.join(d, "hb")
        w0 = HeartbeatWriter(hb_dir, 0, interval_s=0.0, world=3, epoch=1)
        w0.beat(19, step_time_ema=0.011, last_ft="preempt")
        with open(os.path.join(hb_dir, "heartbeat-00001.jsonl"), "w") as f:
            f.write(json.dumps({"pid": 1, "step": 3, "t": now - 120}) + "\n")
        with open(os.path.join(hb_dir, "membership.json"), "w") as f:
            f.write(json.dumps({"epoch": 1, "ranks": [0, 1, 2]}))
        # telemetry CSV (statistics.sh contract)
        tpath = os.path.join(d, "telemetry.csv")
        with open(tpath, "w", newline="") as f:
            wr = csv.writer(f)
            for t in range(4):
                for dev in range(2):
                    wr.writerow([now + t, dev, 8 << 30,
                                 (1 + t) << 20, (2 + t) << 20])

        # a one-entry comm ledger on disk for the comms section, as the
        # JAX obs/comms.py writes it (the port has no producer yet)
        entry = {"name": "all-reduce.1", "kind": "all-reduce",
                 "bytes": 66952, "wire_bytes": 100428.0, "n_groups": 1,
                 "group_size": 4, "phase": "backward",
                 "op_name": "jit(step)/transpose(jvp(lm_forward))/add",
                 "source": "lm.py:1", "wire_encoding": "f32", "bucket": -1}
        lpath = os.path.join(d, "comm_ledger.json")
        with open(lpath, "w") as f:
            json.dump({"lm_train_dp": {
                "step": "lm_train_dp", "mesh_shape": {"data": 4},
                "total_bytes": 66952, "total_wire_bytes": 100428.0,
                "count": 1, "peak_hbm_bytes": 0.0,
                "by_kind": {"all-reduce": {"count": 1, "bytes": 66952,
                                           "wire_bytes": 100428.0}},
                "by_phase": {"backward": {"count": 1, "bytes": 66952,
                                          "wire_bytes": 100428.0}},
                "entries": [entry]}}, f, indent=2, sort_keys=True)

        # a one-entry memory ledger on disk for the memory section, as the
        # JAX obs/memory.py writes it
        buffers = [
            {"name": "(params)", "bytes": 400, "dtype": "", "dims": [],
             "klass": "params", "phase": "", "op_name": "", "source": "",
             "defined_at": -1, "last_use": 8},
            {"name": "fusion.7", "bytes": 96, "dtype": "f32", "dims": [4, 6],
             "klass": "activations", "phase": "backward",
             "op_name": "transpose(jvp(lm_forward))/dot",
             "source": "lm.py:1", "defined_at": 2, "last_use": 5}]
        mlpath = os.path.join(d, "mem_ledger.json")
        with open(mlpath, "w") as f:
            json.dump({"lm_train_dp": {
                "step": "lm_train_dp", "mesh_shape": {"data": 4},
                "argument_bytes": 400, "output_bytes": 300,
                "donated_bytes": 128, "peak_bytes": 820, "peak_index": 3,
                "n_instructions": 9, "measured_peak_bytes": 800.0,
                "residual_pct": 2.5,
                "class_peaks": {"params": 400, "activations": 96},
                "phase_peaks": {"resident": 400, "backward": 96},
                "watermark": [[0, 700], [2, 820], [6, 724]],
                "top": buffers}}, f, indent=2, sort_keys=True)

        # a 20-days-stale LKG + events trail for the bench aging line
        bench_lkg = os.path.join(d, "BENCH_LKG.json")
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S%z",
                              time.localtime(now - 20 * 86400))
        with open(bench_lkg, "w") as f:
            json.dump({"metric": "resnet50_train_images_per_sec_per_chip",
                       "value": 2511.3, "vs_baseline": 9.3,
                       "captured_at": stamp,
                       # bench.py stamps the planner prediction on capture
                       "predicted_mfu": 42.0, "measured_mfu": 39.5,
                       "prediction_drift_pct": -6.0}, f)
        bench_events = os.path.join(d, "bench_events.jsonl")
        with open(bench_events, "w") as f:
            f.write(json.dumps({"bench_event": "stale", "t": now - 3600,
                                "reason": "tunnel unreachable"}) + "\n")

        # an autoplan payload (the JAX planner's lm-tiny sweep at 4 chips,
        # cut to what the report reads) for the plan section + the --diff
        # drift row
        flags = ["--vocab", "64", "--d-model", "32", "--n-layers", "1",
                 "--n-heads", "4", "--seq-len", "16", "--batch-size", "8"]
        plan = {"chips": 4, "dp": 4, "tp": 1, "pp": 1, "fsdp": False,
                "key": "c4/dp4", "flags": flags,
                "cli": "python -m pytorch_distributed_tpu_torch.recipes."
                       "lm_pretrain " + " ".join(flags)}
        ppath = os.path.join(d, "plan.json")
        with open(ppath, "w") as f:
            json.dump({"schema_version": 1, "model": "lm-tiny",
                       "family": "lm", "chips": 4,
                       "hw": {"name": "cpu", "peak_flops": 5e10},
                       "ranked": [{"plan": plan, "predicted": {
                           "step_time_ms": 0.05942424,
                           "payload_bytes": 66952.0,
                           "wire_bytes": 100428.0,
                           "peak_hbm_bytes": 404744.0,
                           "mfu_pct": 99.99798062204918}}]}, f)

        ns = argparse.Namespace(
            metrics_jsonl=mpath, hb_dir=hb_dir, telemetry_csv=tpath,
            now=now, max_step_lag=3, max_beat_age=60.0,
            comm_ledger=lpath, comm_predicted=66000.0,
            mem_ledger=mlpath, bench_lkg=bench_lkg,
            bench_events=bench_events, bench_max_stale_days=14.0,
            plan=ppath)
        out = report(ns)
        for needle in ("== steps ==", "steps logged      20", "p95",
                       "throughput", "loss", "grad_norm",
                       "mfu               mean", "malformed lines   1",
                       "== ft events ==", "skip", "rollback", "preempt",
                       "lr scale          0.5 after 1 rollback",
                       "== goodput ==", "goodput", "badput/nan_skip",
                       "badput/rollback_discard", "badput/remesh",
                       "alerts fired      2",
                       "== alerts ==", "step_time_p95", "[warn]",
                       "dead_rank", "[page]", "ranks 1",
                       "step time p95 22.0ms > 15ms",
                       "membership epoch 1: world 3 ranks [0, 1, 2]",
                       "epoch 1",
                       "== comms ==", "per-step payload  66952 B",
                       "16 collectives", "exposed comm      0.400 ms",
                       "overlap 33.3%", "residual", "[ok]",
                       "ledger lm_train_dp", "all-reduce×1",
                       "by phase: backward",
                       "== memory ==", "per-step peak",
                       "residual 2.5% [ok]", "by class (MiB):",
                       "by phase (MiB):", "top: fusion.7",
                       "== plan ==", "chosen            c4/dp4",
                       "cli               python -m "
                       "pytorch_distributed_tpu_torch.recipes.lm_pretrain",
                       "predicted", "drift",
                       "== bench ==", "stale", "last good",
                       "days ago", "1 stale event(s)",
                       "plan mfu          predicted 42.0%",
                       "drift -6.0%",
                       "WARN", "benchmark stale",
                       "== devices ==", "device 0", "device 1",
                       "== heartbeats ==", "STRAGGLER", "step lag",
                       "beat age"):
            assert needle in out, f"selftest: {needle!r} missing from:\n{out}"

        # json twin: every section present and structurally sane
        js = report_json(ns)
        for key in ("steps", "ft_events", "goodput", "bench", "comms",
                    "memory", "bench_staleness", "devices", "heartbeats",
                    "plan", "alerts"):
            assert key in js, f"selftest: {key!r} missing from json: {js}"
        assert js["alerts"]["total"] == 2, js["alerts"]
        assert js["alerts"]["by_name"]["dead_rank"]["severity"] == "page"
        assert js["alerts"]["by_name"]["step_time_p95"]["steps"] == [15]
        assert js["goodput"]["alerts"] == 2, js["goodput"]
        assert js["steps"]["alerts"] == 2.0, js["steps"]
        assert js["plan"]["key"] == "c4/dp4", js["plan"]
        assert js["plan"]["predicted_mfu_pct"] > 0, js["plan"]
        assert js["plan"]["mfu_drift_pct"] is not None, js["plan"]
        assert js["steps"]["model_comm_bytes"] == 66952.0, js["steps"]
        assert abs(js["comms"]["residual_pct"]) < 15.0, js["comms"]
        assert js["comms"]["ledger"]["lm_train_dp"]["total_bytes"] == 66952
        assert js["memory"]["mem_peak_bytes"] == 820.0, js["memory"]
        mled = js["memory"]["ledger"]["lm_train_dp"]
        assert mled["peak_bytes"] == 820 and mled["residual_pct"] == 2.5
        assert mled["class_peaks"]["params"] == 400, mled
        assert js["bench_staleness"]["warn"], js["bench_staleness"]
        assert 19.5 < js["bench_staleness"]["days_stale"] < 20.5, (
            js["bench_staleness"])
        assert js["bench_staleness"]["prediction_drift_pct"] == -6.0, (
            js["bench_staleness"])
        assert js["heartbeats"]["1"]["straggler"], js["heartbeats"]
        assert not js["heartbeats"]["0"]["straggler"], js["heartbeats"]
        assert js["heartbeats"]["0"]["epoch"] == 1, js["heartbeats"]
        assert js["membership"] == {"epoch": 1, "ranks": [0, 1, 2]}, js
        assert js["goodput"]["counts"]["remesh"] == 1, js["goodput"]
        json.dumps(js)  # must be serializable end-to-end
        # pid 0 must NOT be flagged
        line0 = [ln for ln in out.splitlines() if "process 0" in ln]
        assert line0 and "STRAGGLER" not in line0[0], out

        # ---- diff fences: identical runs PASS, a slowed run REGRESSes ----
        fast = os.path.join(d, "fast.jsonl")
        slow = os.path.join(d, "slow.jsonl")
        for path, st in ((fast, 0.010), (slow, 0.015)):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(30):
                    log.log_step(i, step_time=st, n_items=128, lr=0.1,
                                 extra={"mfu": 40.0 * 0.010 / st,
                                        "hfu": 44.0 * 0.010 / st})
        a_recs, _ = load_metrics(fast)
        b_recs, _ = load_metrics(slow)
        text, regressed = diff_report(a_recs, b_recs)
        assert regressed, f"selftest: slowed run must REGRESS:\n{text}"
        for needle in ("== diff ==", "step_time_p50", "REGRESS",
                       "overall: REGRESS", "throughput", "mfu",
                       "badput_remesh_s"):
            assert needle in text, f"selftest: {needle!r} missing from:\n{text}"
        text2, regressed2 = diff_report(a_recs, a_recs)
        assert not regressed2 and "overall: PASS" in text2, (
            f"selftest: identical runs must PASS:\n{text2}")

        # ---- planted exposed-comm regression: identical step time, but
        # collectives stopped hiding under compute -> the comm fence (and
        # only the comm fence) must REGRESS
        base_c = os.path.join(d, "base_comm.jsonl")
        bad_c = os.path.join(d, "bad_comm.jsonl")
        for path, exposed in ((base_c, 0.20), (bad_c, 0.55)):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(30):
                    log.log_step(i, step_time=0.010, n_items=128, lr=0.1,
                                 extra={"model_comm_bytes": 66952.0,
                                        "comm_wire_bytes": 100428.0,
                                        "exposed_comm_ms": exposed,
                                        "overlap_pct": 60.0})
        c_recs, _ = load_metrics(base_c)
        d_recs, _ = load_metrics(bad_c)
        text3, regressed3 = diff_report(c_recs, d_recs)
        assert regressed3, (
            f"selftest: exposed-comm regression must REGRESS:\n{text3}")
        row = [ln for ln in text3.splitlines() if "exposed_comm_ms" in ln]
        assert row and "REGRESS" in row[0], text3
        step_row = [ln for ln in text3.splitlines() if "step_time_p50" in ln]
        assert step_row and "PASS" in step_row[0], text3
        dd = diff_data(c_recs, d_recs)
        assert dd["overall"] == "REGRESS" and dd["regressed"], dd
        by_name = {r["metric"]: r for r in dd["metrics"]}
        assert by_name["exposed_comm_ms"]["verdict"] == "REGRESS", dd
        assert by_name["comm_wire_bytes"]["verdict"] == "PASS", dd
        json.dumps(dd)

        # ---- planted peak-HBM regression: same timings, compiled peak
        # grew (e.g. a --zero wus run accidentally fell back to replicated
        # optimizer state) -> only the peak_hbm_bytes fence must REGRESS
        base_m = os.path.join(d, "base_mem.jsonl")
        bad_m = os.path.join(d, "bad_mem.jsonl")
        for path, peak in ((base_m, 2.0e8), (bad_m, 3.1e8)):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(30):
                    log.log_step(i, step_time=0.010, n_items=128, lr=0.1,
                                 extra={"model_comm_bytes": 66952.0,
                                        "comm_wire_bytes": 100428.0,
                                        "peak_hbm_bytes": peak})
        m_recs, _ = load_metrics(base_m)
        n_recs, _ = load_metrics(bad_m)
        text4, regressed4 = diff_report(m_recs, n_recs)
        assert regressed4, (
            f"selftest: peak-HBM regression must REGRESS:\n{text4}")
        dm = diff_data(m_recs, n_recs)
        by_name4 = {r["metric"]: r for r in dm["metrics"]}
        assert by_name4["peak_hbm_bytes"]["verdict"] == "REGRESS", dm
        assert by_name4["comm_wire_bytes"]["verdict"] == "PASS", dm
        # reverse direction (the memory WIN) must pass the peak fence
        # (row-scoped: the wall-clock goodput metric is timing-noisy here)
        dr = diff_data(n_recs, m_recs)
        by_rev = {r["metric"]: r for r in dr["metrics"]}
        assert by_rev["peak_hbm_bytes"]["verdict"] == "PASS", dr

        # ---- planted alert regression: identical timings, but the
        # candidate run fired an alert -> only the alerts row REGRESSes
        # (any new firing fails the fence; counts render as counts)
        alerted = os.path.join(d, "alerted.jsonl")
        with MetricsLogger(alerted, flush_every=50) as log:
            for i in range(30):
                log.log_step(i, step_time=0.010, n_items=128, lr=0.1,
                             extra={"mfu": 40.0, "hfu": 44.0})
            log.log_event("alert", step=25, alert="goodput_floor",
                          rule="goodput_floor", severity="warn",
                          detail="goodput estimate 41% < 50%")
        al_recs, _ = load_metrics(alerted)
        text5, regressed5 = diff_report(a_recs, al_recs)
        assert regressed5, (
            f"selftest: a new alert must REGRESS the diff:\n{text5}")
        al_row = [ln for ln in text5.splitlines()
                  if ln.strip().startswith("alerts")]
        assert al_row and "REGRESS" in al_row[0], text5
        assert "+1" in al_row[0] and "pp" not in al_row[0], al_row
        da = diff_data(a_recs, al_recs)
        assert {r["metric"]: r for r in da["metrics"]}[
            "alerts"]["verdict"] == "REGRESS", da
        # reverse (alerts cleared in the candidate) passes the row
        dr_a = diff_data(al_recs, a_recs)
        assert {r["metric"]: r for r in dr_a["metrics"]}[
            "alerts"]["verdict"] == "PASS", dr_a

        # ---- bench staleness in --diff: a note, never a failure ----
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_diff(fast, fast, 10.0, 5.0, staleness={
                "warn": True, "days_stale": 20.0, "max_stale_days": 14.0})
        noted = buf.getvalue()
        assert rc == 0, f"selftest: stale bench must not fail --diff:\n{noted}"
        assert "note: benchmark baseline stale 20.0 days" in noted, noted
        assert "overall: PASS" in noted, noted

        # ---- plan drift row in --diff: also a note, never a failure ----
        buf2 = io.StringIO()
        with contextlib.redirect_stdout(buf2):
            rc2 = run_diff(fast, fast, 10.0, 5.0, plan=load_plan(ppath))
        drifted = buf2.getvalue()
        assert rc2 == 0, (
            f"selftest: plan drift must not fail --diff:\n{drifted}")
        assert "plan_mfu_drift" in drifted, drifted
        assert "not a fence" in drifted, drifted
        assert "overall: PASS" in drifted, drifted

        # ---- --strict: the same stale capture IS a failure (the CI
        # posture refuses to certify against old numbers) ----
        buf3 = io.StringIO()
        with contextlib.redirect_stdout(buf3):
            rc3 = run_diff(fast, fast, 10.0, 5.0, staleness={
                "warn": True, "days_stale": 20.0, "max_stale_days": 14.0},
                strict=True)
        strict_out = buf3.getvalue()
        assert rc3 == 1, "selftest: --strict must fail a stale diff"
        assert "STRICT: benchmark baseline stale" in strict_out, strict_out
        # report path: same 20-day LKG, strict fails, default stays 0
        buf3b = io.StringIO()
        with contextlib.redirect_stdout(buf3b):
            rc4 = main(["--metrics-jsonl", mpath, "--bench-lkg", bench_lkg,
                        "--bench-events", bench_events, "--strict",
                        "--now", repr(now)])
            rc5 = main(["--metrics-jsonl", mpath, "--bench-lkg", bench_lkg,
                        "--bench-events", bench_events, "--now", repr(now)])
        assert rc4 == 1, "selftest: strict report must fail on stale LKG"
        assert rc5 == 0, "selftest: non-strict report must stay exit 0"

        # ---- synclint fold: section, json twin, strict fence ----
        sync_ok = os.path.join(d, "synclint_ok.json")
        sync_bad = os.path.join(d, "synclint_bad.json")
        clean_step = {
            "name": "lm_train_dp", "mesh_shape": {"data": 4},
            "findings": [], "collectives": {}, "memory": {},
            "donation": {}, "sync_digest": "a" * 64}
        proto_step = {
            "name": "sync-protocols", "mesh_shape": {}, "collectives": {},
            "memory": {}, "donation": {}, "sync_digest": "",
            "findings": [{"kind": "protocol-desync", "severity": "info",
                          "where": "proto:preempt-stop",
                          "message": "verified desync-free"}]}
        with open(sync_ok, "w") as f:
            json.dump([clean_step, proto_step], f)
        desync_step = {
            "name": "sync-scopes", "mesh_shape": {}, "collectives": {},
            "memory": {}, "donation": {}, "sync_digest": "",
            "findings": [{"kind": "collective-desync", "severity": "error",
                          "where": "train/lm.py:1500",
                          "message": "collective call step_fn() is "
                                     "reachable under a rank-dependent "
                                     "branch"}]}
        with open(sync_bad, "w") as f:
            json.dump([clean_step, proto_step, desync_step], f)
        ns_sync = argparse.Namespace(
            metrics_jsonl=None, hb_dir=None, telemetry_csv=None, now=now,
            max_step_lag=3, max_beat_age=60.0, bench_lkg=None,
            bench_events=None, bench_max_stale_days=14.0, plan=None,
            flight_dir=None, synclint_json=sync_ok)
        sync_out = report(ns_sync)
        for needle in ("== synclint ==",
                       "1 collective schedule(s) digest-verified",
                       "1 protocol(s) model-checked desync-free",
                       "congruence clean: no desync findings"):
            assert needle in sync_out, (
                f"selftest: {needle!r} missing from:\n{sync_out}")
        js_sync = report_json(ns_sync)
        assert js_sync["synclint"]["errors"] == 0, js_sync["synclint"]
        assert js_sync["synclint"]["schedules_pinned"] == 1, (
            js_sync["synclint"])
        ns_sync.synclint_json = sync_bad
        bad_out = report(ns_sync)
        assert "[error] collective-desync @ train/lm.py:1500" in bad_out, (
            bad_out)
        js_bad = report_json(ns_sync)
        assert js_bad["synclint"]["errors"] == 1, js_bad["synclint"]
        assert js_bad["synclint"]["by_kind"] == {
            "collective-desync": 1}, js_bad["synclint"]
        buf_sync = io.StringIO()
        with contextlib.redirect_stdout(buf_sync):
            # a fresh LKG of its own and a fixed clock: the strict
            # synclint fence must not trip on a benchmark's age
            fresh = os.path.join(d, "BENCH_LKG_fresh.json")
            with open(fresh, "w") as f:
                json.dump({"metric": "resnet50_train_images_per_sec_per_chip",
                           "captured_at": time.strftime(
                               "%Y-%m-%dT%H:%M:%S%z", time.localtime(now))}, f)
            clock = ["--bench-lkg", fresh, "--now", repr(now)]
            rc_s_ok = main(["--synclint-json", sync_ok, "--strict"] + clock)
            rc_s_note = main(["--synclint-json", sync_bad] + clock)
            rc_s_bad = main(["--synclint-json", sync_bad, "--strict"] + clock)
        assert rc_s_ok == 0, "selftest: strict clean synclint must pass"
        assert rc_s_note == 0, (
            "selftest: non-strict synclint errors stay exit 0 (a note)")
        assert rc_s_bad == 1, (
            "selftest: --strict must fail on synclint error findings")

        # ---- serving plane: section, json twin, planted TTFT fence ----
        # a training-shaped run must not grow a serving section
        assert "== serving ==" not in out, out
        spath = os.path.join(d, "serving.jsonl")
        with MetricsLogger(spath, flush_every=50) as log:
            for i in range(10):
                log.log_step(i, step_time=0.005, n_items=32,
                             extra={"serving": 1.0,
                                    "queue_depth": float(max(0, 5 - i)),
                                    "active_seqs": 4.0,
                                    "kv_occupancy_pct": 55.0 + i,
                                    "kv_frag_pct": 12.5,
                                    "preemptions": 1.0,
                                    "requests_completed": float(i),
                                    "tokens_per_s": 512.0,
                                    "ttft_p50_ms": 40.0,
                                    "ttft_p95_ms": 75.0,
                                    "ttft_p99_ms": 80.0,
                                    "itl_p50_ms": 4.0, "itl_p95_ms": 9.0,
                                    "itl_p99_ms": 12.0})
            log.log_event("serve_preempt", step=4, rid=3)
            log.log_event("serve_defrag", step=7, defrags=1)
        ns_s = argparse.Namespace(
            metrics_jsonl=spath, hb_dir=None, telemetry_csv=None, now=now,
            max_step_lag=3, max_beat_age=60.0, bench_lkg=None,
            bench_events=None, bench_max_stale_days=14.0, plan=None,
            flight_dir=None)
        srv_out = report(ns_s)
        for needle in ("== serving ==", "512.0 tok/s",
                       "TTFT p50/p95/p99  40.0ms / 75.0ms / 80.0ms",
                       "ITL p50/p95/p99   4.0ms / 9.0ms / 12.0ms",
                       "queue depth peak  5.0",
                       "KV occupancy peak 64.0%",
                       "preemptions       1.0;  defrags 1"):
            assert needle in srv_out, (
                f"selftest: {needle!r} missing from:\n{srv_out}")
        js_s = report_json(ns_s)
        assert js_s["serving"]["ttft_p99_ms"] == 80.0, js_s["serving"]
        assert js_s["serving"]["kv_occupancy_peak_pct"] == 64.0, (
            js_s["serving"])
        assert js_s["steps"]["ttft_p99_ms"] == 80.0, js_s["steps"]
        assert js_s["steps"]["tokens_per_s"] == 512.0, js_s["steps"]
        json.dumps(js_s)

        # planted TTFT regression: same step times and throughput, but
        # first tokens land 2.5x later -> the ttft_p99_ms fence (and only
        # it) must REGRESS, and the --diff CLI must exit 1
        base_s = os.path.join(d, "serve_base.jsonl")
        bad_s = os.path.join(d, "serve_slow_ttft.jsonl")
        for path, ttft in ((base_s, 80.0), (bad_s, 200.0)):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(10):
                    log.log_step(i, step_time=0.005, n_items=32,
                                 extra={"serving": 1.0,
                                        "tokens_per_s": 512.0,
                                        "ttft_p99_ms": ttft})
        sa_recs, _ = load_metrics(base_s)
        sb_recs, _ = load_metrics(bad_s)
        text6, regressed6 = diff_report(sa_recs, sb_recs)
        assert regressed6, (
            f"selftest: planted TTFT regression must REGRESS:\n{text6}")
        ds = diff_data(sa_recs, sb_recs)
        by_srv = {r["metric"]: r for r in ds["metrics"]}
        assert by_srv["ttft_p99_ms"]["verdict"] == "REGRESS", ds
        assert by_srv["step_time_p50"]["verdict"] == "PASS", ds
        assert by_srv["tokens_per_s"]["verdict"] == "PASS", ds
        # reverse direction (TTFT improved) passes the row
        dr_s = diff_data(sb_recs, sa_recs)
        assert {r["metric"]: r for r in dr_s["metrics"]}[
            "ttft_p99_ms"]["verdict"] == "PASS", dr_s
        buf_s = io.StringIO()
        with contextlib.redirect_stdout(buf_s):
            rc_s = run_diff(base_s, bad_s, 10.0, 5.0)
        assert rc_s == 1, "selftest: planted TTFT regression must exit 1"
        assert "ttft_p99_ms" in buf_s.getvalue(), buf_s.getvalue()
        # training-only diffs skip the serving rows (missing, not a fail)
        assert {r["metric"]: r for r in diff_data(a_recs, b_recs)[
            "metrics"]}["ttft_p99_ms"]["verdict"] == "missing"
        # ...and untraced serving runs skip the attribution rows
        assert by_srv["queue_wait_share_p99"]["verdict"] == "missing", ds
        assert by_srv["preempt_redo_ms_p99"]["verdict"] == "missing", ds

        # ---- traces plane: section, json twin, tail rollup ----
        tpath = os.path.join(d, "traces.jsonl")
        with MetricsLogger(tpath, flush_every=50) as log:
            for i in range(8):
                storm = i >= 6  # two tail requests dominated by redo
                ttft = 300.0 if storm else 50.0
                redo = 240.0 if storm else 0.0
                queue = 40.0 if storm else 35.0
                log.log_event(
                    "reqtrace", step=i, rid=i,
                    trace_id=f"ptd-engine:0-{i:08x}",
                    ttft_ms=ttft, e2e_ms=ttft + 20.0, tokens=8,
                    preemptions=3 if storm else 0,
                    queue_wait_ms=queue, prefill_ms=10.0,
                    redo_wait_ms=redo, defrag_wait_ms=0.0,
                    other_wait_ms=ttft - queue - 10.0 - redo,
                    decode_ms=18.0, redo_own_ms=0.0, defrag_run_ms=0.0,
                    other_run_ms=2.0, preempt_redo_ms=redo,
                    queue_wait_share_pct=100.0 * queue / ttft,
                    violated=1 if storm else 0, n_spans=12,
                    spans_dropped=0, sampled=1)
        ns_t = argparse.Namespace(
            metrics_jsonl=tpath, hb_dir=None, telemetry_csv=None, now=now,
            max_step_lag=3, max_beat_age=60.0, bench_lkg=None,
            bench_events=None, bench_max_stale_days=14.0, plan=None,
            flight_dir=None)
        trc_out = report(ns_t)
        for needle in ("== traces ==", "8 request trace(s)",
                       "2 SLO violation(s)", "6 preemption(s)",
                       "tail attribution:",
                       "dominant tail component: preempt_redo"):
            assert needle in trc_out, (
                f"selftest: {needle!r} missing from:\n{trc_out}")
        js_t = report_json(ns_t)
        assert js_t["traces"]["requests"] == 8, js_t["traces"]
        assert js_t["traces"]["tail"]["dominant"] == "preempt_redo", (
            js_t["traces"])
        json.dumps(js_t)
        # an untraced run must not grow the section
        assert "== traces ==" not in srv_out, srv_out

        # planted preemption storm: identical step times / throughput /
        # TTFT fence inputs -- the NEW attribution rows (and only they)
        # must flip the diff to REGRESS and the CLI to exit 1
        base_t = os.path.join(d, "attr_base.jsonl")
        bad_t = os.path.join(d, "attr_storm.jsonl")
        for path, (share, redo_ms) in ((base_t, (12.0, 0.0)),
                                       (bad_t, (55.0, 210.0))):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(10):
                    log.log_step(i, step_time=0.005, n_items=32,
                                 extra={"serving": 1.0,
                                        "tokens_per_s": 512.0,
                                        "ttft_p99_ms": 80.0,
                                        "queue_wait_share_p99": share,
                                        "preempt_redo_ms_p99": redo_ms})
        ta_recs, _ = load_metrics(base_t)
        tb_recs, _ = load_metrics(bad_t)
        dt = diff_data(ta_recs, tb_recs)
        by_t = {r["metric"]: r for r in dt["metrics"]}
        assert by_t["queue_wait_share_p99"]["verdict"] == "REGRESS", dt
        assert by_t["preempt_redo_ms_p99"]["verdict"] == "REGRESS", dt
        assert by_t["ttft_p99_ms"]["verdict"] == "PASS", dt
        # the improvement direction passes both rows
        by_rt = {r["metric"]: r
                 for r in diff_data(tb_recs, ta_recs)["metrics"]}
        assert by_rt["queue_wait_share_p99"]["verdict"] == "PASS", by_rt
        assert by_rt["preempt_redo_ms_p99"]["verdict"] == "PASS", by_rt
        buf_t = io.StringIO()
        with contextlib.redirect_stdout(buf_t):
            rc_t = run_diff(base_t, bad_t, 10.0, 5.0)
        assert rc_t == 1, (
            "selftest: planted preemption storm must exit 1")
        assert "preempt_redo_ms_p99" in buf_t.getvalue(), buf_t.getvalue()

        # ---- attribution plane: section, json twin, diff ----
        from pytorch_distributed_tpu_torch.obs import stepattr as sa_mod

        def write_attr_run(path, comp, sync_ms, data_ms, other):
            # identical 100ms step times: only the composition differs,
            # so the NEW attribution rows (and only they) may flip
            with MetricsLogger(path, flush_every=50) as log:
                prof = sa_mod.phase_profile(
                    {"forward": 1e9, "backward": 2e9, "update": 1e7},
                    {"forward": 1e7, "backward": 2e7, "update": 1e8},
                    comm_bytes=1e6, peak_flops=1e12, hbm_bw=1e11,
                    link_bw=1e10, n_devices=1)
                log.log_event("stepattr_phases",
                              **sa_mod.phase_event_fields(prof))
                for i in range(10):
                    log.log_step(i, step_time=0.100, n_items=32, extra={
                        "attr_compute_ms": comp,
                        "attr_exposed_comm_ms": 8.0,
                        "attr_host_sync_ms": sync_ms,
                        "attr_data_wait_ms": data_ms,
                        "attr_other_ms": other,
                        "attr_device_ms": comp + 8.0,
                        "attr_comm_ms": 20.0,
                        "attr_recon_err_ms": 0.02,
                        "data_wait_share": data_ms})
        attr_base = os.path.join(d, "sa_base.jsonl")
        attr_bad = os.path.join(d, "sa_starved.jsonl")
        write_attr_run(attr_base, comp=62.0, sync_ms=3.0, data_ms=8.0,
                       other=19.0)
        write_attr_run(attr_bad, comp=42.0, sync_ms=12.0, data_ms=30.0,
                       other=8.0)
        ns_at = argparse.Namespace(
            metrics_jsonl=attr_base, hb_dir=None, telemetry_csv=None,
            now=now, max_step_lag=3, max_beat_age=60.0, bench_lkg=None,
            bench_events=None, bench_max_stale_days=14.0, plan=None,
            flight_dir=None)
        at_out = report(ns_at)
        for needle in ("== attribution ==", "dominant: compute",
                       "identity recon", "% of step p50",
                       "data_wait_share   p50 8.0%  p95 8.0%",
                       "host_sync         p50 3.00ms  p95 3.00ms",
                       "comm overlap      measured 0.60",
                       "fix first: backward"):
            assert needle in at_out, (
                f"selftest: {needle!r} missing from:\n{at_out}")
        js_at = report_json(ns_at)
        assert js_at["attribution"]["dominant"] == "compute", js_at
        assert js_at["attribution"]["recon_err_pct_p50"] <= 0.5, js_at
        roofl = js_at["attribution"]["roofline"]
        at_labels = {p["phase"]: p["label"] for p in roofl["phases"]}
        assert at_labels["update"] == "hbm-bound", at_labels
        assert at_labels["grad_sync"] == "comm-bound", at_labels
        json.dumps(js_at)
        # runs without --step-attr must not grow the section or rows
        assert "== attribution ==" not in srv_out, srv_out
        assert by_srv["data_wait_share_p95"]["verdict"] == "missing", ds
        assert by_srv["host_sync_ms_p95"]["verdict"] == "missing", ds
        # planted input starvation: identical step times, but data-wait
        # share climbs 22pp and host-sync p95 climbs 9ms -> both new
        # rows (and only they) REGRESS, in both text and exit code
        aa_recs, _ = load_metrics(attr_base)
        ab_recs, _ = load_metrics(attr_bad)
        dat = diff_data(aa_recs, ab_recs)
        by_at = {r["metric"]: r for r in dat["metrics"]}
        assert by_at["data_wait_share_p95"]["verdict"] == "REGRESS", dat
        assert by_at["host_sync_ms_p95"]["verdict"] == "REGRESS", dat
        assert by_at["step_time_p50"]["verdict"] == "PASS", dat
        # the improvement direction passes both rows
        by_rat = {r["metric"]: r
                  for r in diff_data(ab_recs, aa_recs)["metrics"]}
        assert by_rat["data_wait_share_p95"]["verdict"] == "PASS", by_rat
        assert by_rat["host_sync_ms_p95"]["verdict"] == "PASS", by_rat
        buf_at = io.StringIO()
        with contextlib.redirect_stdout(buf_at):
            rc_at = run_diff(attr_base, attr_bad, 10.0, 5.0)
        assert rc_at == 1, (
            "selftest: planted input starvation must exit 1")
        assert "data_wait_share_p95" in buf_at.getvalue(), buf_at.getvalue()
        assert "host_sync_ms_p95" in buf_at.getvalue(), buf_at.getvalue()

        # ---- fleet plane: section, json twin, diff rows ----
        def write_fleet(path, retries, hedges_won):
            with MetricsLogger(path, flush_every=50) as log:
                for i in range(12):
                    rep = i % 2
                    log.log_event(
                        "fleettrace", rid=i,
                        trace_id=f"ptd-fleet-{i:08x}", replica=rep,
                        attempts=2 if i < retries else 1, hedged=0,
                        router_wait_ms=1.0,
                        redispatch_ms=30.0 if i < retries else 0.0,
                        hedge_wait_ms=0.0, engine_ttft_ms=40.0,
                        engine_e2e_ms=60.0,
                        router_ttft_ms=(71.0 if i < retries else 41.0),
                        router_e2e_ms=91.0 if i < retries else 61.0)
                log.log_event("replica_down", replica=1,
                              reason="healthz: connection refused")
                log.log_event("scale_up", replica=2,
                              reason="ttft_p99 91.0% of SLO")
                log.log_event("drain", scope="router", inflight=0)
                log.log_step(1, step_time=1.0, extra={
                    "fleet": 1.0, "replicas_up": 2.0,
                    "replicas_quarantined": 1.0, "replicas_total": 3.0,
                    "fleet_requests_routed": 12.0,
                    "fleet_requests_completed": 12.0,
                    "fleet_requests_failed": 0.0,
                    "fleet_retries": float(retries),
                    "fleet_hedges": 4.0,
                    "fleet_hedges_won": float(hedges_won),
                    "fleet_hedges_lost": 4.0 - hedges_won,
                    "fleet_duplicates_suppressed": 0.0,
                    "fleet_replica_down_events": 1.0,
                    "fleet_drain_events": 1.0,
                    "fleet_scale_up_events": 1.0,
                    "fleet_scale_down_events": 0.0,
                    "retry_rate_pct": 100.0 * retries / 12.0,
                    "hedge_win_rate_pct": 100.0 * hedges_won / 4.0})

        fpath = os.path.join(d, "fleet.jsonl")
        write_fleet(fpath, retries=2, hedges_won=3)
        ns_fl = argparse.Namespace(
            metrics_jsonl=fpath, hb_dir=None, telemetry_csv=None, now=now,
            max_step_lag=3, max_beat_age=60.0, bench_lkg=None,
            bench_events=None, bench_max_stale_days=14.0, plan=None,
            flight_dir=None)
        fl_out = report(ns_fl)
        for needle in ("== fleet ==", "2 up / 1 quarantined / 3 total",
                       "routed 12; completed 12",
                       "retries 2 (retry_rate 16.7%)",
                       "won 3 / lost 1, win_rate 75.0%",
                       "replica_down 1;  drain 1;  scale up/down 1/0",
                       "requests by replica: replica0×6, replica1×6",
                       "tail attribution p99: router_wait",
                       "[replica_down] replica=1 (healthz: connection "
                       "refused)",
                       "[scale_up] replica=2"):
            assert needle in fl_out, (
                f"selftest: {needle!r} missing from:\n{fl_out}")
        js_fl = report_json(ns_fl)
        assert js_fl["fleet"]["retries"] == 2.0, js_fl["fleet"]
        assert js_fl["fleet"]["requests_by_replica"] == {
            "0": 6.0, "1": 6.0}, js_fl["fleet"]
        assert js_fl["fleet"]["router_ttft_p99_ms"] == 71.0, js_fl["fleet"]
        assert js_fl["steps"]["retry_rate"] == 100.0 * 2 / 12, js_fl
        json.dumps(js_fl)
        # routerless runs must not grow the section or the diff rows
        assert "== fleet ==" not in srv_out, srv_out
        assert by_srv["retry_rate"]["verdict"] == "missing", ds
        # planted replica flapping: retry_rate climbs 16.7pp and the
        # hedge win rate collapses -> both new rows (and only they)
        # REGRESS
        fbad = os.path.join(d, "fleet_flap.jsonl")
        write_fleet(fbad, retries=4, hedges_won=0)
        fa_recs, _ = load_metrics(fpath)
        fb_recs, _ = load_metrics(fbad)
        dfl = diff_data(fa_recs, fb_recs)
        by_fl = {r["metric"]: r for r in dfl["metrics"]}
        assert by_fl["retry_rate"]["verdict"] == "REGRESS", dfl
        assert by_fl["hedge_win_rate"]["verdict"] == "REGRESS", dfl
        by_rfl = {r["metric"]: r
                  for r in diff_data(fb_recs, fa_recs)["metrics"]}
        assert by_rfl["retry_rate"]["verdict"] == "PASS", by_rfl
        assert by_rfl["hedge_win_rate"]["verdict"] == "PASS", by_rfl

        # ---- --flight-dir: the postmortem fold ----
        pm = _postmortem_mod()
        fdir = os.path.join(d, "flight")
        pm.make_fixture(fdir)
        buf4 = io.StringIO()
        with contextlib.redirect_stdout(buf4):
            rc6 = main(["--flight-dir", fdir])
        fold = buf4.getvalue()
        assert rc6 == 0, fold
        for needle in ("== postmortem ==", "stalled first", "hang"):
            assert needle in fold, f"selftest: {needle!r} missing:\n{fold}"
        js_f = report_json(argparse.Namespace(
            metrics_jsonl=None, hb_dir=None, telemetry_csv=None,
            flight_dir=fdir, now=now))
        assert js_f["postmortem"]["n_ranks"] == 2, js_f
        assert js_f["postmortem"]["stalled_rank"] == 1, js_f
        json.dumps(js_f["postmortem"])
        # an empty dir degrades to a note, never a crash
        empty_f = os.path.join(d, "noflight")
        os.makedirs(empty_f)
        sec = postmortem_section(empty_f)
        assert any("no flightrec_rank" in ln for ln in sec), sec
    print("obs_report selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a run's observability artifacts")
    ap.add_argument("--metrics-jsonl", type=str, default=None,
                    dest="metrics_jsonl")
    ap.add_argument("--hb-dir", type=str, default=None, dest="hb_dir")
    ap.add_argument("--telemetry-csv", type=str, default=None,
                    dest="telemetry_csv")
    ap.add_argument("--comm-ledger", type=str, default=None,
                    dest="comm_ledger",
                    help="comm_ledger.json (the JAX repo's shardlint "
                    "--comm-ledger) to itemize in the comms section")
    ap.add_argument("--comm-predicted", type=float, default=None,
                    dest="comm_predicted", metavar="BYTES",
                    help="analytic per-step comm bytes (obs.flops."
                    "lm_comm_bytes/image_comm_bytes) to fence the measured "
                    "ledger against (±15%% residual)")
    ap.add_argument("--mem-ledger", type=str, default=None,
                    dest="mem_ledger",
                    help="mem_ledger.json (the JAX repo's shardlint "
                    "--mem-ledger or a trainer's --mem-ledger) to itemize "
                    "in the memory section: watermark peak vs "
                    "memory_analysis, class/phase breakdown, top buffers")
    ap.add_argument("--plan", type=str, default=None, metavar="PLAN_JSON",
                    help="autoplan payload (the JAX repo's autoplan --out) to "
                    "fold in: the chosen plan + predicted vs measured "
                    "MFU/wire-bytes/peak-HBM drift; in --diff, adds the "
                    "predicted-vs-measured MFU residual row (a note, "
                    "never a verdict)")
    ap.add_argument("--bench-lkg", type=str, default=None, dest="bench_lkg",
                    help="BENCH_LKG.json for staleness aging (default: none; "
                    "only a file named here is aged)")
    ap.add_argument("--bench-events", type=str, default=None,
                    dest="bench_events",
                    help="bench_events.jsonl for staleness aging (default: "
                    "none; missing is fine)")
    ap.add_argument("--bench-max-stale-days", type=float, default=14.0,
                    dest="bench_max_stale_days", metavar="DAYS",
                    help="WARN in the bench section (and note in --diff) "
                    "when the last good benchmark capture is older than "
                    "DAYS (default 14; 0 disables); with --strict the "
                    "WARN is a failing fence")
    ap.add_argument("--strict", action="store_true",
                    help="promote the bench-staleness WARN to a failure: "
                    "exit 1 from the report and from --diff when the last "
                    "good benchmark is older than --bench-max-stale-days")
    ap.add_argument("--synclint-json", type=str, default=None,
                    dest="synclint_json", metavar="PATH",
                    help="synclint/shardlint --json capture to fold in as "
                    "the '== synclint ==' cross-rank congruence section; "
                    "with --strict, any error-severity sync finding "
                    "(incongruent schedule, digest drift, host desync, "
                    "protocol counterexample) fails the report")
    ap.add_argument("--flight-dir", type=str, default=None,
                    dest="flight_dir", metavar="DIR",
                    help="directory with flight-recorder dumps "
                    "(flightrec_rank*.json) to fold in as the "
                    "'== postmortem ==' cross-rank root-cause section")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format; json emits every section (and "
                    "--diff verdicts) as one machine-readable object")
    ap.add_argument("--max-step-lag", type=int, default=3, dest="max_step_lag",
                    help="flag processes more than N steps behind the lead")
    ap.add_argument("--max-beat-age", type=float, default=60.0,
                    dest="max_beat_age",
                    help="flag processes whose newest beat is older (seconds)")
    ap.add_argument("--now", type=float, default=None,
                    help=argparse.SUPPRESS)  # fixed clock for tests
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="compare two metrics JSONL runs (A = baseline, "
                    "B = candidate): step-time p50/p95, throughput, MFU, "
                    "goodput with PASS/REGRESS verdicts; exit 1 on REGRESS")
    ap.add_argument("--threshold-pct", type=float, default=10.0,
                    dest="threshold_pct",
                    help="relative regression threshold for --diff "
                    "(default 10%%)")
    ap.add_argument("--goodput-threshold-pp", type=float, default=5.0,
                    dest="goodput_threshold_pp",
                    help="absolute goodput regression threshold for --diff "
                    "in percentage points (default 5)")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize artifacts, run the report, verify it")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    if args.diff:
        return run_diff(args.diff[0], args.diff[1], args.threshold_pct,
                        args.goodput_threshold_pp, fmt=args.format,
                        staleness=bench_staleness_info(args),
                        plan=(load_plan(args.plan) if args.plan else None),
                        strict=getattr(args, "strict", False))
    if args.format == "json":
        print(json.dumps(report_json(args), indent=2))
    else:
        print(report(args))
    rc = 0
    staleness = bench_staleness_info(args)
    if (getattr(args, "strict", False) and staleness is not None
            and staleness.get("warn")):
        print(f"STRICT: benchmark baseline stale "
              f"{staleness['days_stale']:.1f} days "
              f"(> {staleness['max_stale_days']:g}) — failing",
              file=sys.stderr)
        rc = 1
    if getattr(args, "strict", False) and getattr(
            args, "synclint_json", None):
        sstats = synclint_stats(args.synclint_json)
        n_sync_err = sstats.get("errors", 0)
        if "error" in sstats or n_sync_err:
            what = (sstats.get("error")
                    or f"{n_sync_err} error-severity sync finding(s)")
            print(f"STRICT: synclint fold failing — {what}",
                  file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
