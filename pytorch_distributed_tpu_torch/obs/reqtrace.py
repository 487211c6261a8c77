"""Per-request tracing + SLO attribution for the serving engine: a copy of
``pytorch_distributed_tpu/obs/reqtrace.py`` (the same records, fields and
analyzers, so the JAX package's readers fold the port's runs).

The obs stack explains every *step* (ledgers, flight recorder, live
gauges), but the engine's aggregate quantiles cannot say whether a
``ttft_p99`` breach came from queue wait, chunked-prefill compute,
preemption-recompute, or defrag stalls.  This module is the
request-scoped plane:

- ``TraceContext`` — the explicit serializable record (trace_id, submit
  clock, hop list) the router/replica fleet propagates across processes
  unchanged.  The scheduler appends lifecycle hops by duck typing
  (``ctx.hops.append(...)``) so serving/ never imports obs/.
- ``ReqTracer`` — a bounded, lazy-flush span recorder with the
  flight-recorder overhead discipline: every hot-path hook is a tuple
  append (plus a couple of monotonic-clock reads the engine already
  pays); all serialization and I/O happen at the per-step drain.  A
  global span budget caps memory; overflow is *counted*
  (``spans_dropped``), never silently swallowed, and attribution stays
  correct under drops because it runs off per-request scalar state, not
  the span buffer.
- the critical-path analyzer — each completed request's TTFT decomposes
  exactly into ``queue_wait + prefill + preempt_redo + defrag + other``
  (the redo/defrag terms are the overlap of the request's queue window
  with the engine-wide redo-prefill/defrag intervals the tracer keeps),
  and the post-first-token phase into ``decode + redo_own + defrag +
  other`` — both sides on the engine clock, so attributed sums
  reconcile with the engine's measured TTFT/e2e by construction
  (held to ±5% by the tests and ``chip_smoke.py``).
- tail-based sampling — every SLO-violating trace keeps its full span
  list; non-violators keep spans at a deterministic ``sample`` rate
  (rid-hash, no RNG state).  Attribution aggregates are computed for
  *all* requests regardless of sampling.
- ``tail_attribution()`` — the rollup behind ``tools/obs_trace.py``:
  "p99 TTFT = 61% queue wait, 24% preempt-redo, …".

Stdlib only (no torch, no numpy): ``tools/obs_trace.py`` imports it and
asserts torch stays unimported.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

# TTFT components, in render order (shares of the tail rollup).
TTFT_COMPONENTS = ("queue_wait", "prefill", "preempt_redo", "defrag", "other")


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (obs/metrics.py semantics, re-stated here
    so this module stays import-free for the torch-free CLI)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _overlap_ms(intervals, lo: float, hi: float) -> float:
    """Overlap of ``[lo, hi)`` with the *union* of an interval list, in
    ms.  The union matters: discarded-tenure and redo-prefill intervals
    from concurrent victims overlap each other, and a plain per-interval
    sum would double-count the covered wall — breaking the components-
    sum-to-TTFT contract."""
    clipped = sorted((max(lo, a), min(hi, b)) for a, b in intervals
                     if b > lo and a < hi)
    tot = 0.0
    end = lo
    for a, b in clipped:
        a = max(a, end)
        if b > a:
            tot += b - a
            end = b
    return tot * 1e3


@dataclasses.dataclass
class TraceContext:
    """The propagatable identity of one request.

    ``hops`` is the lifecycle/topology path ("engine:0", "queue",
    "admit", "requeue", …); a router prepends its own hop and ships the
    record unchanged — ``to_wire``/``from_wire`` is the cross-process
    format (plain dict, json-safe).
    """

    trace_id: str
    rid: int
    submit_t: float            # engine clock, seconds
    hops: List[str] = dataclasses.field(default_factory=list)

    def to_wire(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "rid": self.rid,
                "submit_t": round(self.submit_t, 6),
                "hops": list(self.hops)}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "TraceContext":
        return cls(trace_id=str(d["trace_id"]), rid=int(d["rid"]),
                   submit_t=float(d["submit_t"]),
                   hops=[str(h) for h in d.get("hops", [])])


class _ReqState:
    """Scalar per-request attribution state (survives span drops)."""

    __slots__ = ("ctx", "submit_t", "admit_t", "first_token_t",
                 "prefill_ms", "redo_prefill_ms", "decode_ms",
                 "requeue_raw_ms", "requeue_defrag_ms", "preempt_t",
                 "tenure_t", "preempts", "spans", "dropped")

    def __init__(self, ctx: TraceContext):
        self.ctx = ctx
        self.submit_t = ctx.submit_t
        self.admit_t: Optional[float] = None
        self.tenure_t: Optional[float] = None  # current admission's start
        self.first_token_t: Optional[float] = None
        self.prefill_ms = 0.0        # first-pass prefill (pre-first-token)
        self.redo_prefill_ms = 0.0   # recompute-redo prefill after preempt
        self.decode_ms = 0.0         # this request's share of decode calls
        self.requeue_raw_ms = 0.0    # preempt -> re-admit wall
        self.requeue_defrag_ms = 0.0  # defrag overlap of requeue windows
        self.preempt_t: Optional[float] = None
        self.preempts = 0
        self.spans: List[Tuple] = []  # (kind, t0, t1, aux) — bounded
        self.dropped = 0


class ReqTracer:
    """Bounded per-request span recorder + attribution aggregator.

    Hook methods are called by the engine/scheduler on the serving hot
    path; each is a few scalar ops and at most one tuple append.  All
    derived work (attribution math, JSON encoding) runs at request
    completion / drain time, never per token.
    """

    def __init__(self, *, slo_ms: Optional[float] = None,
                 sample: float = 0.05, max_spans: int = 65536,
                 max_intervals: int = 1024, max_pending: int = 8192,
                 window: int = 512, hop: str = "engine:0"):
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.sample = max(0.0, min(1.0, float(sample)))
        self.max_spans = int(max_spans)
        self.max_pending = int(max_pending)
        self.hop = hop
        self._state: Dict[int, _ReqState] = {}
        self._nspans = 0
        self._pending: List[Dict[str, Any]] = []
        # engine-wide interval lists (bounded): what the queue window
        # overlaps against.  deque(maxlen) drops the OLDEST interval —
        # old intervals can only matter to requests that have been
        # queued longer than the window covers, which under-attributes
        # (falls back to queue_wait), never mis-attributes.
        self._redo_iv: deque = deque(maxlen=int(max_intervals))
        self._defrag_iv: deque = deque(maxlen=int(max_intervals))
        # rolling attribution windows feeding the live gauges/alerts
        self._q_share: deque = deque(maxlen=int(window))
        self._redo_ms: deque = deque(maxlen=int(window))
        # counters
        self.completed = 0
        self.violations = 0
        self.sampled_kept = 0
        self.spans_dropped = 0
        self.records_dropped = 0
        self.redo_prefills = 0

    # ------------------------------------------------------------- span ring
    def _span(self, st: _ReqState, kind: str, t0: float, t1: float,
              aux: int = 0) -> None:
        if self._nspans >= self.max_spans:
            st.dropped += 1
            self.spans_dropped += 1
            return
        st.spans.append((kind, t0, t1, aux))
        self._nspans += 1

    # ----------------------------------------------------------- engine hooks
    def on_submit(self, rid: int, t: float, priority: int = 0
                  ) -> TraceContext:
        ctx = TraceContext(trace_id=f"ptd-{self.hop}-{rid:08x}", rid=rid,
                           submit_t=t, hops=[self.hop])
        st = _ReqState(ctx)
        self._state[rid] = st
        self._span(st, "submit", t, t, priority)
        return ctx

    def on_admit(self, rid: int, t: float) -> None:
        st = self._state.get(rid)
        if st is None:
            return
        st.tenure_t = t
        if st.admit_t is None:
            st.admit_t = t
            self._span(st, "queue", st.submit_t, t)
        else:                      # re-admission after a preemption
            if st.preempt_t is not None:
                raw = t - st.preempt_t
                st.requeue_raw_ms += raw * 1e3
                st.requeue_defrag_ms += _overlap_ms(
                    self._defrag_iv, st.preempt_t, t)
                self._span(st, "requeue_wait", st.preempt_t, t)
                st.preempt_t = None

    def on_prefill(self, rid: int, t_marks: Sequence[float], redo: bool
                   ) -> None:
        """``t_marks``: chunk boundaries, first = prefill start, last =
        post-sync (the engine's first-token stamp).  One span per chunk;
        the last chunk absorbs the host sync."""
        st = self._state.get(rid)
        if st is None or len(t_marks) < 2:
            return
        kind = "redo_prefill" if redo else "prefill"
        for i in range(len(t_marks) - 1):
            self._span(st, kind, t_marks[i], t_marks[i + 1], i)
        dur_ms = (t_marks[-1] - t_marks[0]) * 1e3
        if redo:
            st.redo_prefill_ms += dur_ms
            self.redo_prefills += 1
            self._redo_iv.append((t_marks[0], t_marks[-1]))
        else:
            st.prefill_ms += dur_ms
            st.first_token_t = t_marks[-1]

    def on_decode(self, rid: int, t0: float, t1: float,
                  n_tokens: int) -> None:
        st = self._state.get(rid)
        if st is None:
            return
        st.decode_ms += (t1 - t0) * 1e3
        self._span(st, "decode", t0, t1, n_tokens)

    def on_emit(self, rid: int, t: float, first: bool) -> None:
        st = self._state.get(rid)
        if st is None:
            return
        self._span(st, "emit", t, t, 1 if first else 0)

    def on_preempt(self, rid: int, t: float) -> None:
        st = self._state.get(rid)
        if st is None:
            return
        st.preempts += 1
        st.preempt_t = t
        # everything this lane computed since (re-)admission is discarded
        # and will be recomputed — the whole tenure is preempt-redo wall,
        # not just the later redo prefill.
        if st.tenure_t is not None:
            self._redo_iv.append((st.tenure_t, t))
            st.tenure_t = None
        self._span(st, "preempt", t, t, st.preempts)

    def on_defrag(self, t0: float, t1: float) -> None:
        self._defrag_iv.append((t0, t1))

    # ------------------------------------------------------------ completion
    def _keep_spans(self, rid: int, violated: bool) -> bool:
        if violated:
            return True             # tail-based sampling: keep every violator
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        # deterministic, stateless: Knuth multiplicative hash of the rid
        return ((rid * 2654435761) & 0xFFFFFFFF) / 2**32 < self.sample

    def on_complete(self, rid: int, t: float, tokens: int,
                    preemptions: int) -> None:
        st = self._state.pop(rid, None)
        if st is None:
            return
        self._span(st, "complete", t, t, tokens)
        self._nspans -= len(st.spans)   # spans leave the buffer with the record
        self.completed += 1

        admit_t = st.admit_t if st.admit_t is not None else st.submit_t
        ftt = st.first_token_t if st.first_token_t is not None else t
        ttft_ms = (ftt - st.submit_t) * 1e3
        e2e_ms = (t - st.submit_t) * 1e3

        # --- TTFT window: queue_wait + prefill + preempt_redo + defrag
        #     + other == ttft, exactly (engine clock on both sides).
        redo_wait_ms = _overlap_ms(self._redo_iv, st.submit_t, admit_t)
        defrag_wait_ms = _overlap_ms(self._defrag_iv, st.submit_t, admit_t)
        queue_wait_ms = max(
            0.0, (admit_t - st.submit_t) * 1e3 - redo_wait_ms
            - defrag_wait_ms)
        other_wait_ms = max(0.0, ttft_ms - queue_wait_ms - redo_wait_ms
                            - defrag_wait_ms - st.prefill_ms)

        # --- post-first-token phase: decode + redo_own + defrag + other
        phase_ms = max(0.0, e2e_ms - ttft_ms)
        redo_own_ms = (st.redo_prefill_ms + st.requeue_raw_ms
                       - st.requeue_defrag_ms)
        defrag_run_ms = _overlap_ms(self._defrag_iv, ftt, t)
        other_run_ms = max(0.0, phase_ms - st.decode_ms - redo_own_ms
                           - defrag_run_ms)

        preempt_redo_ms = redo_wait_ms + redo_own_ms
        q_share = 100.0 * queue_wait_ms / ttft_ms if ttft_ms > 0 else 0.0
        violated = self.slo_ms is not None and ttft_ms > self.slo_ms
        if violated:
            self.violations += 1
        self._q_share.append(q_share)
        self._redo_ms.append(preempt_redo_ms)

        ev: Dict[str, Any] = {
            "rid": rid,
            "trace_id": st.ctx.trace_id,
            "submit_t": round(st.submit_t, 6),
            "ttft_ms": round(ttft_ms, 4),
            "e2e_ms": round(e2e_ms, 4),
            "tokens": int(tokens),
            "preemptions": int(preemptions),
            "queue_wait_ms": round(queue_wait_ms, 4),
            "prefill_ms": round(st.prefill_ms, 4),
            "redo_wait_ms": round(redo_wait_ms, 4),
            "defrag_wait_ms": round(defrag_wait_ms, 4),
            "other_wait_ms": round(other_wait_ms, 4),
            "decode_ms": round(st.decode_ms, 4),
            "redo_own_ms": round(redo_own_ms, 4),
            "defrag_run_ms": round(defrag_run_ms, 4),
            "other_run_ms": round(other_run_ms, 4),
            "preempt_redo_ms": round(preempt_redo_ms, 4),
            "queue_wait_share_pct": round(q_share, 3),
            "violated": 1 if violated else 0,
            "n_spans": len(st.spans),
            "spans_dropped": st.dropped,
            "ctx": json.dumps(st.ctx.to_wire(), sort_keys=True),
        }
        if self._keep_spans(rid, violated):
            self.sampled_kept += 1
            ev["sampled"] = 1
            # spans as a JSON *string*: MetricsLogger.flush float()-casts
            # any non-primitive field, so lists must not leak through.
            ev["spans"] = json.dumps(
                [[k, round(a, 6), round(b - a, 6), x]
                 for (k, a, b, x) in st.spans])
        else:
            ev["sampled"] = 0
        if len(self._pending) < self.max_pending:
            self._pending.append(ev)
        else:
            self.records_dropped += 1

    # ----------------------------------------------------------------- drain
    def drain(self) -> List[Dict[str, Any]]:
        """Completed trace records since the last drain (lazy flush: the
        engine calls this once per step and books each record as one
        ``reqtrace`` ft_event)."""
        out, self._pending = self._pending, []
        return out

    def step_fields(self) -> Dict[str, float]:
        """Rolling attribution gauges for the per-step metrics record
        (→ ``ptd_serving_attr_*`` exposition, alert rules, obs_report)."""
        out: Dict[str, float] = {
            "trace_completed": float(self.completed),
            "trace_spans_dropped": float(self.spans_dropped),
        }
        if self._q_share:
            qs = sorted(self._q_share)
            out["queue_wait_share_p50"] = _percentile(qs, 0.5)
            out["queue_wait_share_p99"] = _percentile(qs, 0.99)
        if self._redo_ms:
            rd = sorted(self._redo_ms)
            out["preempt_redo_ms_p50"] = _percentile(rd, 0.5)
            out["preempt_redo_ms_p99"] = _percentile(rd, 0.99)
        return out


# ---------------------------------------------------------------- analysis
# Pure functions over drained/parsed trace records — shared by
# tools/obs_trace.py (torch-free), tools/chaoskit.py and chip_smoke.py.


def trace_records(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Filter a parsed metrics-JSONL stream down to reqtrace events."""
    return [r for r in records if r.get("ft_event") == "reqtrace"]


def _ttft_components_ms(r: Dict[str, Any]) -> Dict[str, float]:
    return {
        "queue_wait": float(r.get("queue_wait_ms", 0.0)),
        "prefill": float(r.get("prefill_ms", 0.0)),
        "preempt_redo": float(r.get("redo_wait_ms", 0.0)),
        "defrag": float(r.get("defrag_wait_ms", 0.0)),
        "other": float(r.get("other_wait_ms", 0.0)),
    }


def tail_attribution(trs: Sequence[Dict[str, Any]], q: float = 0.99
                     ) -> Optional[Dict[str, Any]]:
    """Attribute the TTFT tail: among requests at/above the q-quantile
    TTFT, what share of their (mean) TTFT does each component own?"""
    trs = [r for r in trs if "ttft_ms" in r]
    if not trs:
        return None
    ttfts = sorted(float(r["ttft_ms"]) for r in trs)
    cut = _percentile(ttfts, q)
    tail = [r for r in trs if float(r["ttft_ms"]) >= cut]
    mean_ttft = sum(float(r["ttft_ms"]) for r in tail) / len(tail)
    comps = {k: 0.0 for k in TTFT_COMPONENTS}
    for r in tail:
        for k, v in _ttft_components_ms(r).items():
            comps[k] += v
    for k in comps:
        comps[k] /= len(tail)
    denom = max(mean_ttft, 1e-9)
    shares = {k: 100.0 * v / denom for k, v in comps.items()}
    dominant = max(shares, key=lambda k: shares[k])
    return {"q": q, "n_tail": len(tail), "ttft_tail_ms": cut,
            "mean_tail_ttft_ms": mean_ttft, "components_ms": comps,
            "shares_pct": shares, "dominant": dominant}


def attribution_summary(trs: Sequence[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Aggregate stats over all completed-request trace records."""
    trs = [r for r in trs if "ttft_ms" in r]
    if not trs:
        return None
    def p(field: str, q: float) -> float:
        return _percentile(sorted(float(r.get(field, 0.0)) for r in trs), q)
    recon = [abs(float(r["ttft_ms"])
                 - sum(_ttft_components_ms(r).values()))
             for r in trs]
    out = {
        "requests": len(trs),
        "violations": sum(int(r.get("violated", 0)) for r in trs),
        "sampled_kept": sum(int(r.get("sampled", 0)) for r in trs),
        "spans_dropped": sum(int(r.get("spans_dropped", 0)) for r in trs),
        "preemptions": sum(int(r.get("preemptions", 0)) for r in trs),
        "ttft_p50_ms": p("ttft_ms", 0.5),
        "ttft_p99_ms": p("ttft_ms", 0.99),
        "e2e_p99_ms": p("e2e_ms", 0.99),
        "queue_wait_share_p99": p("queue_wait_share_pct", 0.99),
        "preempt_redo_ms_p99": p("preempt_redo_ms", 0.99),
        "recon_err_ms_max": max(recon),
        "tail": tail_attribution(trs),
    }
    return out


def fleet_trace_records(records: Sequence[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """Filter a parsed metrics-JSONL stream down to the fleet router's
    per-request ``fleettrace`` events (serving/router.py)."""
    return [r for r in records if r.get("ft_event") == "fleettrace"]


def fleet_reconciliation(fleet_trs: Sequence[Dict[str, Any]],
                         engine_trs: Sequence[Dict[str, Any]] = ()
                         ) -> Optional[Dict[str, Any]]:
    """Reconcile the router's latency attribution.

    Two exactness contracts, both checked per request:

    1. Decomposition: ``router_ttft_ms == router_wait_ms +
       redispatch_ms + hedge_wait_ms + engine_ttft_ms`` — the router
       books these so the identity holds by construction; any drift
       means double-counted or lost wall clock.
    2. Engine echo: when the same JSONL also holds the replicas'
       ``reqtrace`` events, the ``engine_ttft_ms`` the router echoed
       must match the engine's own ``ttft_ms`` for that rid — the
       router is reporting the engine's truth, not its own estimate.

    Returns None when there are no fleet traces (routerless runs)."""
    fleet_trs = list(fleet_trs)
    if not fleet_trs:
        return None
    decomp = []
    for t in fleet_trs:
        lhs = float(t.get("router_ttft_ms", 0.0))
        rhs = (float(t.get("router_wait_ms", 0.0))
               + float(t.get("redispatch_ms", 0.0))
               + float(t.get("hedge_wait_ms", 0.0))
               + float(t.get("engine_ttft_ms", 0.0)))
        decomp.append(abs(lhs - rhs))
    by_rid: Dict[Any, List[Dict[str, Any]]] = {}
    for r in engine_trs:
        by_rid.setdefault(r.get("rid"), []).append(r)
    matched = 0
    echo = []
    for t in fleet_trs:
        cands = by_rid.get(t.get("rid"))
        if not cands:
            continue
        matched += 1
        echo.append(min(abs(float(t.get("engine_ttft_ms", 0.0))
                            - float(c.get("ttft_ms", 0.0)))
                        for c in cands))
    waits = sorted(float(t.get("router_wait_ms", 0.0)) for t in fleet_trs)
    return {
        "requests": len(fleet_trs),
        "retried": sum(1 for t in fleet_trs
                       if int(t.get("attempts", 1)) > 1),
        "hedged": sum(1 for t in fleet_trs if t.get("hedged")),
        "decomp_err_ms_max": max(decomp),
        "engine_matched": matched,
        "engine_echo_err_ms_max": max(echo) if echo else None,
        "router_wait_p99_ms": _percentile(waits, 0.99),
        "router_ttft_p99_ms": _percentile(
            sorted(float(t.get("router_ttft_ms", 0.0))
                   for t in fleet_trs), 0.99),
    }


def format_tail_line(tail: Dict[str, Any]) -> str:
    """'p99 TTFT 812.4ms = 61% queue_wait, 24% preempt_redo, …'"""
    shares = tail["shares_pct"]
    parts = ", ".join(f"{shares[k]:.0f}% {k}" for k in TTFT_COMPONENTS
                      if shares[k] >= 0.5)
    return (f"p{int(tail['q'] * 100)} TTFT {tail['mean_tail_ttft_ms']:.1f}ms"
            f" = {parts}")


def chrome_events(trs: Sequence[Dict[str, Any]], pid: int = 9000,
                  process_name: str = "serving requests"
                  ) -> List[Dict[str, Any]]:
    """Chrome-trace events for per-request tracks (one tid per request;
    engine-clock seconds → trace µs).  Only records that retained their
    span list (``sampled``) render; aggregate-only records have no
    geometry to draw."""
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": pid, "name": "process_name",
        "args": {"name": process_name}}]
    for r in trs:
        spans = r.get("spans")
        if not spans:
            continue
        if isinstance(spans, str):
            spans = json.loads(spans)
        tid = int(r.get("rid", 0))
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": f"req {tid} "
                                        f"({r.get('trace_id', '?')})"}})
        for kind, t0, dur, aux in spans:
            ev = {"ph": "X", "pid": pid, "tid": tid, "name": str(kind),
                  "ts": float(t0) * 1e6, "dur": max(float(dur) * 1e6, 1.0),
                  "args": {"aux": aux}}
            if kind in ("redo_prefill", "requeue_wait", "preempt"):
                ev["cat"] = "preempt"
            events.append(ev)
    return events
