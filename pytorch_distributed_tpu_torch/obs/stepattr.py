"""Exact per-step wall-time attribution + roofline classifier: a copy of
``pytorch_distributed_tpu/obs/stepattr.py`` (stdlib only), stamping the
same ``attr_*`` fields, so either package's readers fold either's runs.

    step_time == device_compute + exposed_comm + host_sync
                 + data_wait + other        (recon err <= 0.5% of p50)

**Runtime side** (``StepAttr``): the trainers (``--step-attr``) time
three host wall windows per step with ``perf_counter`` —

- ``data_wait``  around batch acquisition,
- ``device``     around the train step call *plus* an explicit
  ``torch.cuda.synchronize()`` (the twin of the JAX package's
  ``block_until_ready``: without it, asynchronous launches smear step N's
  device time into step N+1's windows),
- ``host_sync``  around the remaining host-side drains (meters update,
  metrics logging — the lazy-flush scalar conversion spikes land here),

and close ``other`` as the residual against the meters' step seconds, so
the identity holds *by construction*; the reconciliation error is
exactly the amount by which the measured windows overshoot the step.
The device window splits into ``compute + exposed_comm`` via an exposure
fraction: measured from a timeline when one exists
(``exposure_from_timeline``), estimated from a comm ledger's wire bytes
against the link bandwidth otherwise — either way the split sums back to
the device window exactly.  The port has no comm ledger yet (ROADMAP.md
item A13), so its runs book the whole device window as compute.

**Offline side**: ``summarize`` folds the stamped ``attr_*`` record
fields into p50/p95 shares + the dominant bottleneck class;
``phase_profile``/``roofline`` label each phase compute-bound /
hbm-bound / comm-bound / host-bound from the analytic FLOPs and bytes
against the card's peaks; ``write_attr``/``load_attr`` carry the measured
profile to the JAX package's planner.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

# Attribution component order: the identity, in render order.
COMPONENTS = ("compute", "exposed_comm", "host_sync", "data_wait", "other")

# Per-record fields stamped into the metrics JSONL by ``StepAttr.fields``
# (prefixed so the exporter's gauge promotion can pattern on them).
ATTR_FIELDS = (
    "attr_compute_ms", "attr_exposed_comm_ms", "attr_host_sync_ms",
    "attr_data_wait_ms", "attr_other_ms", "attr_device_ms",
    "attr_comm_ms", "attr_recon_err_ms", "data_wait_share",
)

# Assumed backward-overlap fraction for the ledger-estimate exposure
# split — plan/cost.py's DEFAULT_OVERLAP, restated here so this module
# stays import-free for the jax-free CLI.  A timeline capture replaces
# the assumption with a measurement (``exposure_from_timeline``).
ASSUMED_OVERLAP = 0.6

_EMA_ALPHA = 0.1


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (obs/metrics.py semantics)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


# ------------------------------------------------------------------ runtime

class StepAttr:
    """Per-step wall-window recorder for the trainer hot loops.

    Usage (both trainers, behind ``--step-attr``)::

        sa = StepAttr(link_bytes_per_s=chip_link_bytes(kind))
        ...
        with sa.data_wait():
            batch = next(batch_iter)
        with sa.device():
            metrics = step(batch, lr)
            torch.cuda.synchronize()
        with sa.host_sync():
            dt = meters.update(metrics, n)
        extra.update(sa.fields(dt))      # closes the identity, resets

    Windows accumulate within a step (a retried ``next()`` adds to the
    same ``data_wait``); ``fields`` consumes them.  Overhead is six
    ``perf_counter`` calls + one small dict per step, plus the
    synchronize's cost to the launch queue.
    """

    def __init__(self, comm_bytes_per_step: float = 0.0,
                 link_bytes_per_s: Optional[float] = None,
                 assumed_overlap: float = ASSUMED_OVERLAP):
        self.comm_bytes_per_step = float(comm_bytes_per_step)
        self.link_bytes_per_s = link_bytes_per_s
        self.assumed_overlap = float(assumed_overlap)
        # timeline-measured exposure overrides the ledger estimate
        self._exposed_frac: Optional[float] = None
        self._comm_frac: Optional[float] = None
        self.exposure_source = "ledger"
        self._t_data = self._t_device = self._t_sync = 0.0
        self.data_wait_ema_ms: Optional[float] = None

    # -- wiring ----------------------------------------------------------
    def set_comm_bytes(self, nbytes: float) -> None:
        """Per-step wire bytes from the comm ledger (set once the lazily
        emitted ledgers exist — earlier steps fall back to comm=0)."""
        self.comm_bytes_per_step = float(nbytes)

    def set_exposure(self, exposed_frac: float,
                     comm_frac: Optional[float] = None,
                     source: str = "timeline") -> None:
        """Measured split: ``exposed_frac`` of the device window is
        exposed comm (``comm_frac`` of it is collective time at all) —
        from ``exposure_from_timeline`` on a profiler capture."""
        self._exposed_frac = min(1.0, max(0.0, float(exposed_frac)))
        if comm_frac is not None:
            self._comm_frac = min(1.0, max(0.0, float(comm_frac)))
        self.exposure_source = source

    # -- the three windows ----------------------------------------------
    @contextmanager
    def data_wait(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._t_data += time.perf_counter() - t0

    @contextmanager
    def device(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._t_device += time.perf_counter() - t0

    @contextmanager
    def host_sync(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._t_sync += time.perf_counter() - t0

    def restart(self) -> None:
        """Drop half-collected windows (eval/checkpoint boundaries —
        the meters' ``restart_clock`` twin)."""
        self._t_data = self._t_device = self._t_sync = 0.0

    # -- closing the identity -------------------------------------------
    def _split_device(self, device_ms: float) -> tuple:
        """(compute_ms, exposed_ms, comm_ms): exact within the window."""
        if device_ms <= 0.0:
            return 0.0, 0.0, 0.0
        if self._exposed_frac is not None:
            exposed = self._exposed_frac * device_ms
            comm = ((self._comm_frac * device_ms)
                    if self._comm_frac is not None else exposed)
        else:
            bw = self.link_bytes_per_s or 0.0
            est = (1e3 * self.comm_bytes_per_step / bw) if bw > 0 else 0.0
            comm = min(device_ms, est)
            exposed = min(device_ms, (1.0 - self.assumed_overlap) * est)
        comm = max(comm, exposed)
        return device_ms - exposed, exposed, comm

    def fields(self, step_time_s: float) -> Dict[str, float]:
        """Close the identity against the meters' step seconds and reset
        the windows.  ``other`` is the residual (logging, heartbeats, lr
        math — host work outside the three windows), clamped at zero;
        ``attr_recon_err_ms`` is the clamp amount, i.e. the exact error
        of ``sum(components) == step_time``."""
        total_ms = max(0.0, step_time_s * 1e3)
        data_ms = self._t_data * 1e3
        device_ms = self._t_device * 1e3
        sync_ms = self._t_sync * 1e3
        self._t_data = self._t_device = self._t_sync = 0.0

        compute_ms, exposed_ms, comm_ms = self._split_device(device_ms)
        residual = total_ms - (device_ms + sync_ms + data_ms)
        other_ms = max(0.0, residual)
        recon_err = max(0.0, -residual)

        if self.data_wait_ema_ms is None:
            self.data_wait_ema_ms = data_ms
        else:
            self.data_wait_ema_ms += _EMA_ALPHA * (
                data_ms - self.data_wait_ema_ms)

        return {
            "attr_compute_ms": round(compute_ms, 4),
            "attr_exposed_comm_ms": round(exposed_ms, 4),
            "attr_host_sync_ms": round(sync_ms, 4),
            "attr_data_wait_ms": round(data_ms, 4),
            "attr_other_ms": round(other_ms, 4),
            "attr_device_ms": round(device_ms, 4),
            "attr_comm_ms": round(comm_ms, 4),
            "attr_recon_err_ms": round(recon_err, 4),
            "data_wait_share": round(
                100.0 * data_ms / total_ms if total_ms > 0 else 0.0, 3),
        }


def exposure_from_timeline(step_stats: Sequence[Any]) -> Optional[Dict[str, float]]:
    """Fold ``obs.timeline.analyze_steps`` records into the measured
    device-window split: mean exposed/window and comm/window fractions
    (feed to ``StepAttr.set_exposure``).  None with no device streams."""
    stats = [s for s in step_stats if getattr(s, "window_ns", 0) > 0]
    if not stats:
        return None
    exposed = sum(s.exposed_ns / s.window_ns for s in stats) / len(stats)
    comm = sum(s.comm_ns / s.window_ns for s in stats) / len(stats)
    return {"exposed_frac": min(1.0, exposed), "comm_frac": min(1.0, comm)}


# ------------------------------------------------------------------ offline

def step_records(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The stamped step records (``--step-attr`` runs) out of a metrics
    JSONL record stream."""
    return [r for r in records
            if r.get("kind", "step") == "step" and "attr_compute_ms" in r]


def phase_event_fields(profile: Dict[str, Any]) -> Dict[str, Any]:
    """``phase_profile`` output → ft_event payload: the phases list rides
    as a JSON string because ``MetricsLogger.flush`` coerces non-primitive
    values with ``float()`` (``phase_event`` decodes it back)."""
    out = dict(profile)
    out["phases"] = json.dumps(out.get("phases", []))
    return out


def phase_event(records: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The last ``stepattr_phases`` ft_event (the trainer books one per
    run once the ledgers exist), or None."""
    evs = [r for r in records if r.get("ft_event") == "stepattr_phases"]
    if not evs:
        return None
    ev = dict(evs[-1])
    if isinstance(ev.get("phases"), str):
        ev["phases"] = json.loads(ev["phases"])
    return ev


def summarize(records: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Aggregate the per-step attribution into the report/profile form:
    component p50s, shares of step p50, p95 tails for the two diff-fenced
    series, the dominant bottleneck class, the measured overlap fraction,
    and the identity reconciliation (max err, and as % of step p50)."""
    recs = step_records(records)
    if not recs:
        return None

    def col(key):
        return sorted(float(r.get(key, 0.0)) for r in recs)

    step_ms = col("step_time")
    step_ms = [v * 1e3 for v in step_ms]
    step_p50 = _percentile(step_ms, 0.5)
    comp_p50 = {c: _percentile(col(f"attr_{c}_ms"), 0.5)
                for c in COMPONENTS}
    denom = max(step_p50, 1e-9)
    shares = {c: 100.0 * v / denom for c, v in comp_p50.items()}
    recon = [float(r.get("attr_recon_err_ms", 0.0)) for r in recs]
    comm_p50 = _percentile(col("attr_comm_ms"), 0.5)
    overlap = (1.0 - comp_p50["exposed_comm"] / comm_p50
               if comm_p50 > 0 else None)
    dws = col("data_wait_share")
    hs = col("attr_host_sync_ms")
    return {
        "steps": len(recs),
        "step_ms_p50": step_p50,
        "components_ms_p50": comp_p50,
        "shares_pct": shares,
        "dominant": max(shares, key=lambda c: shares[c]),
        "data_wait_share_p50": _percentile(dws, 0.5),
        "data_wait_share_p95": _percentile(dws, 0.95),
        "host_sync_ms_p50": _percentile(hs, 0.5),
        "host_sync_ms_p95": _percentile(hs, 0.95),
        "recon_err_ms_max": max(recon) if recon else 0.0,
        "recon_err_pct_p50": (100.0 * max(recon) / denom) if recon else 0.0,
        "overlap_measured": overlap,
        "exposure_source": recs[-1].get("attr_exposure_source", "ledger"),
    }


# ------------------------------------------------------------------ roofline

def split_step_bytes(total_bytes: float, params: float) -> Dict[str, float]:
    """Decompose a ``StepCost.bytes`` figure (6·4·params state traffic +
    activation traffic) into per-phase HBM bytes, conserving the total:
    forward reads params and writes activations, backward re-reads both
    and writes grads, the optimizer update streams param/momentum/grad
    state with no activation traffic."""
    p4 = 4.0 * float(params)
    act = max(0.0, float(total_bytes) - 24.0 * float(params))
    return {"forward": p4 + act / 2.0,
            "backward": 2.0 * p4 + act / 2.0,
            "update": 3.0 * p4}


def phase_profile(flops_by_phase: Dict[str, float],
                  bytes_by_phase: Dict[str, float],
                  comm_bytes: float = 0.0,
                  peak_flops: float = 0.0,
                  hbm_bw: float = 0.0,
                  link_bw: float = 0.0,
                  n_devices: int = 1) -> Dict[str, Any]:
    """The per-run static phase ledger the trainer books once as a
    ``stepattr_phases`` ft_event: per named_scope phase algorithmic FLOPs
    (StepCost.breakdown) + HBM bytes, the wire bytes of the collective
    phase, and the chip peaks — everything the jax-free roofline needs,
    embedded so the CLI never touches hardware tables."""
    phases = []
    for name, fl in flops_by_phase.items():
        if fl <= 0.0:
            continue
        phases.append({"name": name, "flops": float(fl),
                       "hbm_bytes": float(bytes_by_phase.get(name, 0.0)),
                       "comm_bytes": 0.0})
    if comm_bytes > 0.0:
        phases.append({"name": "grad_sync", "flops": 0.0,
                       "hbm_bytes": 0.0, "comm_bytes": float(comm_bytes)})
    return {"phases": phases, "peak_flops": float(peak_flops),
            "hbm_bw": float(hbm_bw), "link_bw": float(link_bw),
            "n_devices": int(n_devices)}


def roofline(summary: Dict[str, Any], profile: Dict[str, Any],
             top_k: int = 5) -> Dict[str, Any]:
    """Label every phase and rank the fix-first table.

    Compute phases split the measured ``compute`` p50 by FLOPs share and
    are labeled **compute-bound** when their operational intensity
    (flops/byte) clears the chip ridge point (peak_flops / hbm_bw),
    **hbm-bound** below it; the collective phase carries the measured
    ``exposed_comm`` p50 → **comm-bound**; host_sync/data_wait/other →
    **host-bound**.  Ranking is by headroom: time × (1 − achieved/peak),
    i.e. the milliseconds a perfectly-utilized phase would give back.
    """
    comp = summary["components_ms_p50"]
    peak = max(profile.get("peak_flops", 0.0), 1e-9)
    bw = max(profile.get("hbm_bw", 0.0), 1e-9)
    link = max(profile.get("link_bw", 0.0), 1e-9)
    n_dev = max(int(profile.get("n_devices", 1)), 1)
    ridge = peak / bw

    flop_phases = [p for p in profile.get("phases", [])
                   if p.get("flops", 0.0) > 0.0]
    total_flops = sum(p["flops"] for p in flop_phases) or 1.0
    rows: List[Dict[str, Any]] = []
    for p in flop_phases:
        ms = comp["compute"] * p["flops"] / total_flops
        secs = max(ms / 1e3, 1e-12)
        ach_fl = p["flops"] / n_dev / secs
        ach_bw = p.get("hbm_bytes", 0.0) / n_dev / secs
        intensity = (p["flops"] / p["hbm_bytes"]
                     if p.get("hbm_bytes", 0.0) > 0 else float("inf"))
        label = "compute-bound" if intensity >= ridge else "hbm-bound"
        util = (ach_fl / peak) if label == "compute-bound" else (ach_bw / bw)
        util = min(1.0, util)
        rows.append({"phase": p["name"], "ms": ms, "label": label,
                     "flops_util_pct": min(100.0, 100.0 * ach_fl / peak),
                     "hbm_util_pct": min(100.0, 100.0 * ach_bw / bw),
                     "headroom_ms": ms * (1.0 - util)})
    for p in profile.get("phases", []):
        if p.get("comm_bytes", 0.0) <= 0.0:
            continue
        ms = comp["exposed_comm"]
        secs = max(ms / 1e3, 1e-12)
        util = min(1.0, p["comm_bytes"] / n_dev / secs / link)
        rows.append({"phase": p["name"], "ms": ms, "label": "comm-bound",
                     "link_util_pct": 100.0 * util,
                     "headroom_ms": ms * (1.0 - util)})
    for name, ms in (("host_sync", comp["host_sync"]),
                     ("data_wait", comp["data_wait"]),
                     ("other", comp["other"])):
        rows.append({"phase": name, "ms": ms, "label": "host-bound",
                     "headroom_ms": ms})
    fix_first = sorted(rows, key=lambda r: -r["headroom_ms"])[:top_k]
    return {"ridge_flops_per_byte": ridge, "phases": rows,
            "fix_first": fix_first}


# ------------------------------------------------------- the measured profile

def attr_profile(summary: Dict[str, Any],
                 source: str = "") -> Dict[str, Any]:
    """The planner-facing profile: measured overlap + bottleneck shares
    (autoplan ``--attr-from`` swaps these in for plan/cost.py's assumed
    constants; the plan payload records ``attr_source``)."""
    return {
        "kind": "stepattr_profile",
        "attr_source": source,
        "steps": summary["steps"],
        "step_ms_p50": summary["step_ms_p50"],
        "overlap": summary["overlap_measured"],
        "bottleneck": summary["dominant"],
        "shares_pct": summary["shares_pct"],
        "data_wait_share_p95": summary["data_wait_share_p95"],
        "host_sync_ms_p95": summary["host_sync_ms_p95"],
        "recon_err_pct_p50": summary["recon_err_pct_p50"],
    }


def write_attr(path: str, summary: Dict[str, Any]) -> Dict[str, Any]:
    prof = attr_profile(summary, source=path)
    with open(path, "w") as f:
        json.dump(prof, f, indent=2, sort_keys=True)
        f.write("\n")
    return prof


def load_attr(path: str) -> Dict[str, Any]:
    with open(path) as f:
        prof = json.load(f)
    if prof.get("kind") != "stepattr_profile":
        raise ValueError(
            f"{path} is not a stepattr profile (write one with "
            "scripts/obs_roofline.py --attr-out)")
    prof.setdefault("attr_source", path)
    return prof


# ------------------------------------------------------------------ perfetto

def chrome_counter_events(records: Sequence[Dict[str, Any]],
                          pid: int = 0) -> List[Dict[str, Any]]:
    """Per-component Perfetto counter tracks ("ph": "C") over the run's
    step clock — the attribution read against wall time.  Step records
    are laid end-to-end on their own step_time axis (the JSONL carries
    durations, not absolute stamps)."""
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": pid, "name": "process_name",
        "args": {"name": "step attribution"},
    }]
    t_us = 0.0
    for r in step_records(records):
        for c in COMPONENTS:
            events.append({
                "ph": "C", "pid": pid, "ts": t_us,
                "name": f"attr · {c}_ms",
                "args": {"value": float(r.get(f"attr_{c}_ms", 0.0))},
            })
        events.append({
            "ph": "C", "pid": pid, "ts": t_us, "name": "data_wait_share",
            "args": {"value": float(r.get("data_wait_share", 0.0))},
        })
        t_us += max(float(r.get("step_time", 0.0)), 1e-6) * 1e6
    return events


def format_summary_line(summary: Dict[str, Any]) -> str:
    s = summary["shares_pct"]
    parts = " / ".join(f"{c} {s[c]:.1f}%" for c in COMPONENTS)
    return (f"step p50 {summary['step_ms_p50']:.1f}ms = {parts}  "
            f"(dominant: {summary['dominant']})")
