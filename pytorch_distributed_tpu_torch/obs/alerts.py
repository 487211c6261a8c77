"""Declarative alert rules over the unified metrics stream: a copy of
``pytorch_distributed_tpu/obs/alerts.py`` (the same rule kinds, parameters,
default set, latching and ``alert`` ft_event fields), stdlib only.

A small set of *declarative* rules, each anchored to an existing fence or
baseline, evaluated incrementally over the same record stream
``MetricsLogger`` already drains — zero new hot-path work (the engine is
a flush-time step sink, like ``GoodputTracker``).

Rule kinds (anchors in parentheses):

- ``step_time_p95``   step-time quantile ceiling in ms (the
  ``obs_report --diff`` step-time fence / ``BENCH_LKG.json`` trajectory);
- ``goodput_floor``   live productive-seconds / wall-span estimate below
  ``min_pct`` (obs/goodput.py);
- ``exposed_comm``    un-overlapped collective ms per step above
  ``max_ms`` (the PR-6 ``exposed_comm_ms`` fence);
- ``mem_peak``        compiled per-device peak above ``max_bytes``
  (``analysis/baseline.json`` ``peak_hbm_bytes``);
- ``dead_rank`` / ``slow_rank``  heartbeat liveness via the *same*
  ``find_stragglers`` thresholds the elastic coordinator uses — one
  liveness policy, not two;
- ``hang``            the collective-hang watchdog's ``hang`` ft_event
  (obs/flightrec.py);
- ``replica_down``    the fleet router's ``replica_down`` ft_event — a
  serving replica failed its health probe and was quarantined
  (serving/router.py ``ReplicaRegistry``); fires once per replica;
- ``recompile``       post-warmup recompile ft_events beyond
  ``max_events`` (obs/watchdog.py);
- ``bench_stale``     days since the last good benchmark capture beyond
  ``max_days`` (``bench_staleness`` below, a copy of the JAX repo's
  ``scripts/benchlib.py`` one) — the live twin of the ``obs_report
  --strict`` fence.  Unlike the JAX rule it ages only the ``lkg_path`` and
  ``events_path`` the rule names: with none named there is nothing to age
  and it never fires.  The repo root's ``BENCH_LKG.json`` is the JAX
  package's capture on another device, and the port's ``tools/bench.py``
  writes no last-known-good file, so ``--alerts default`` fires nothing on
  a healthy run whatever the date;
- ``ttft_p99``        serving time-to-first-token p99 above ``max_ms``
  (the serving engine's ``ttft_p99_ms`` SLO field, serving/engine.py);
- ``kv_occupancy``    paged KV pool occupancy above ``max_pct`` — the
  early-warning fence before the pool exhausts and preemption starts
  (serving/kvpool.py ``kv_occupancy_pct``);
- ``queue_wait_share``  rolling p99 share of TTFT spent in pure queue
  wait above ``max_pct`` (obs/reqtrace.py attribution — *why* TTFT is
  breaching: admission backlog, not compute);
- ``preempt_redo``    rolling p99 preempt-redo cost per request above
  ``max_ms`` (obs/reqtrace.py — recompute-storm attribution: the KV
  pool is thrashing, grow it or cap admission);
- ``data_wait_share``  per-step share of wall time spent waiting on the
  input pipeline above ``max_pct`` (obs/stepattr.py ``--step-attr``
  attribution — the step is input-starved: fix the loader, not the
  device).

Firing alerts are **booked as ``alert`` ft_events** into the same JSONL
through the engine's ``emit`` callback (the trainers wire it to
``obs.log_event("alert", ...)``), so goodput, postmortem, the flight
ring, and ``obs_report`` fold them with zero new plumbing.  Rules latch:
one alert per breach episode, re-armed when the condition clears.

Stdlib only: the fleet aggregator (``tools/obs_live.py``) evaluates the
same rules on a host with no card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from pytorch_distributed_tpu_torch.obs.heartbeat import find_stragglers

SEVERITIES = ("warn", "page")

#: quantile name -> metrics-record field for the step-time rule
_QUANTILE_FIELDS = {
    "p50": "step_time_p50",
    "p95": "step_time_p95",
    "max": "step_time_max",
    "ema": "step_time_ema",
    "last": "step_time",
}

# kind -> (required params, optional params).  Unknown kinds and unknown
# or missing params are hard errors at load time — a typo'd rules file
# must fail loudly, not silently never fire.
_RULE_SPECS: Dict[str, tuple] = {
    "step_time_p95": ({"max_ms"}, {"quantile", "warmup_steps"}),
    "goodput_floor": ({"min_pct"}, {"min_steps"}),
    "exposed_comm": ({"max_ms"}, set()),
    "mem_peak": ({"max_bytes"}, set()),
    "dead_rank": (set(), {"max_age_s"}),
    "slow_rank": (set(), {"max_step_lag", "slow_ema_factor", "max_age_s"}),
    "hang": (set(), set()),
    "replica_down": (set(), set()),
    "recompile": (set(), {"max_events"}),
    "bench_stale": ({"max_days"}, {"lkg_path", "events_path"}),
    "ttft_p99": ({"max_ms"}, set()),
    "kv_occupancy": ({"max_pct"}, set()),
    "queue_wait_share": ({"max_pct"}, set()),
    "preempt_redo": ({"max_ms"}, set()),
    "data_wait_share": ({"max_pct"}, {"warmup_steps"}),
}
RULE_KINDS = tuple(sorted(_RULE_SPECS))

_STEP_RULE_KINDS = ("step_time_p95", "goodput_floor", "exposed_comm",
                    "mem_peak", "ttft_p99", "kv_occupancy",
                    "queue_wait_share", "preempt_redo",
                    "data_wait_share")


class AlertRuleError(ValueError):
    """A rules file that cannot be trusted: unreadable, not JSON, an
    unknown rule kind, or a missing/mistyped parameter."""


def _split_liveness(flagged: Dict[int, str]):
    """The dead and slow ranks of ``find_stragglers``' verdicts, by the
    reason strings the JAX package's ``ft.elastic.split_liveness`` reads:
    "dead or hung" is dead, "slow rank" (and not dead) is slow."""
    dead = {pid for pid, why in flagged.items() if "dead or hung" in why}
    slow = {pid for pid, why in flagged.items()
            if pid not in dead and "slow rank" in why}
    return dead, slow


@dataclasses.dataclass
class Rule:
    """One declarative rule: a kind, a display name, a severity, and the
    kind's parameters (validated against ``_RULE_SPECS``)."""

    kind: str
    name: str
    severity: str = "warn"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Alert:
    """One firing: booked as an ``alert`` ft_event via ``Alert.fields``."""

    name: str
    kind: str
    severity: str
    detail: str
    step: Optional[int] = None
    value: Optional[float] = None
    threshold: Optional[float] = None
    rank: Optional[int] = None
    t: float = 0.0

    def fields(self) -> Dict[str, Any]:
        """ft_event payload for ``obs.log_event("alert", **fields)``."""
        out: Dict[str, Any] = {"alert": self.name, "rule": self.kind,
                               "severity": self.severity,
                               "detail": self.detail}
        if self.step is not None:
            out["step"] = int(self.step)
        if self.value is not None:
            out["value"] = float(self.value)
        if self.threshold is not None:
            out["threshold"] = float(self.threshold)
        if self.rank is not None:
            out["rank"] = int(self.rank)
        return out


def _parse_rule(raw: Any, index: int) -> Rule:
    where = f"rules[{index}]"
    if not isinstance(raw, dict):
        raise AlertRuleError(f"{where}: expected an object, got "
                             f"{type(raw).__name__}")
    kind = raw.get("kind")
    if kind not in _RULE_SPECS:
        raise AlertRuleError(
            f"{where}: unknown kind {kind!r} (known: {', '.join(RULE_KINDS)})")
    required, optional = _RULE_SPECS[kind]
    severity = raw.get("severity", "warn")
    if severity not in SEVERITIES:
        raise AlertRuleError(f"{where} ({kind}): severity must be one of "
                             f"{SEVERITIES}, got {severity!r}")
    params = {k: v for k, v in raw.items()
              if k not in ("kind", "name", "severity")}
    missing = required - set(params)
    if missing:
        raise AlertRuleError(f"{where} ({kind}): missing required "
                             f"parameter(s) {sorted(missing)}")
    unknown = set(params) - required - optional
    if unknown:
        raise AlertRuleError(
            f"{where} ({kind}): unknown parameter(s) {sorted(unknown)} "
            f"(accepted: {sorted(required | optional)})")
    for k, v in params.items():
        if k in ("lkg_path", "events_path"):
            if not isinstance(v, str):
                raise AlertRuleError(f"{where} ({kind}): {k} must be a "
                                     f"path string, got {type(v).__name__}")
        elif k == "quantile":
            if v not in _QUANTILE_FIELDS:
                raise AlertRuleError(
                    f"{where} ({kind}): quantile must be one of "
                    f"{sorted(_QUANTILE_FIELDS)}, got {v!r}")
        elif not isinstance(v, (int, float)) or isinstance(v, bool):
            raise AlertRuleError(f"{where} ({kind}): {k} must be a number, "
                                 f"got {v!r}")
    return Rule(kind=kind, name=str(raw.get("name", kind)),
                severity=severity, params=params)


def load_rules(path: str) -> List[Rule]:
    """Parse + validate a JSON rules file: ``{"rules": [{...}, ...]}``
    (a bare list also works).  Raises ``AlertRuleError`` with the rule
    index and reason on anything malformed."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except OSError as e:
        raise AlertRuleError(f"cannot read rules file '{path}': {e}")
    except ValueError as e:
        raise AlertRuleError(f"rules file '{path}' is not valid JSON: {e}")
    if isinstance(payload, dict) and isinstance(payload.get("rules"), list):
        raw_rules = payload["rules"]
    elif isinstance(payload, list):
        raw_rules = payload
    else:
        raise AlertRuleError(
            f"rules file '{path}': expected {{\"rules\": [...]}} or a "
            "top-level list of rule objects")
    rules = [_parse_rule(r, i) for i, r in enumerate(raw_rules)]
    names = [r.name for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise AlertRuleError(f"rules file '{path}': duplicate rule "
                             f"name(s) {sorted(dupes)} — give each a "
                             "distinct 'name'")
    return rules


def default_rules() -> List[Rule]:
    """The anchor-free built-in set (``--alerts default``): liveness,
    hang, recompile anomaly, a generous goodput floor, and bench
    staleness at the report's default 14-day window.  Threshold rules
    that need a run-specific anchor (step time, exposed comm, memory)
    belong in a rules file."""
    return [
        Rule("dead_rank", "dead_rank", "page", {"max_age_s": 60.0}),
        Rule("slow_rank", "slow_rank", "warn",
             {"max_step_lag": 3, "slow_ema_factor": 2.0,
              "max_age_s": 60.0}),
        Rule("hang", "hang", "page", {}),
        Rule("recompile", "recompile", "warn", {"max_events": 2}),
        Rule("goodput_floor", "goodput_floor", "warn",
             {"min_pct": 50.0, "min_steps": 50}),
        Rule("bench_stale", "bench_stale", "warn", {"max_days": 14.0}),
    ]


def parse_lkg_time(stamp):
    """``captured_at`` (``%Y-%m-%dT%H:%M:%S%z``) -> epoch seconds, or None
    on anything unparseable."""
    from datetime import datetime

    try:
        return datetime.strptime(str(stamp), "%Y-%m-%dT%H:%M:%S%z").timestamp()
    except (TypeError, ValueError):
        return None


def bench_staleness(lkg_path=None, events_path=None, now=None):
    """Days since the benchmark's last *fresh* capture: the JAX repo's
    ``scripts/benchlib.py::bench_staleness``, aging only the files named.

    A successful benchmark run rewrites the LKG file (its ``captured_at``
    is the last-good mark); ``stale``/``failed`` events in the events log
    never refresh it, but an explicit ``captured`` event does.  Both files
    are optional; a path left None is not read (the JAX function falls back
    to its repo root's files, which the port must not age).  With no
    parseable timestamp the answer is ``None``.  Returns ``{"metric",
    "last_good", "days_stale", "stale_events"}``, plus the planner-drift
    fields (``predicted_mfu``/``measured_mfu``/``prediction_drift_pct``)
    when the freshest capture carries them."""
    metric, last_good_t, last_good = None, None, None
    drift = {}

    def _drift_fields(rec):
        return {k: rec[k] for k in ("predicted_mfu", "measured_mfu",
                                    "prediction_drift_pct")
                if rec.get(k) is not None}

    if lkg_path is not None:
        try:
            with open(lkg_path) as f:
                lkg = json.load(f)
            metric = lkg.get("metric")
            last_good = lkg.get("captured_at")
            last_good_t = parse_lkg_time(last_good)
            drift = _drift_fields(lkg)
        except (OSError, ValueError):
            pass
    stale_events = 0
    if events_path is not None:
        try:
            with open(events_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict) or "bench_event" not in rec:
                        continue
                    kind = str(rec["bench_event"])
                    if kind in ("stale", "failed"):
                        stale_events += 1
                    elif kind == "captured" and rec.get("t") is not None:
                        t = float(rec["t"])
                        if last_good_t is None or t > last_good_t:
                            last_good_t, last_good = t, rec.get("captured_at")
                            drift = _drift_fields(rec)
                        metric = rec.get("metric", metric)
        except OSError:
            pass
    if last_good_t is None:
        return None
    if now is None:
        now = time.time()
    out = {
        "metric": metric,
        "last_good": last_good,
        "days_stale": max(0.0, (now - last_good_t) / 86400.0),
        "stale_events": stale_events,
    }
    out.update(drift)
    return out


class AlertEngine:
    """Incremental rule evaluation with per-episode latching.

    - ``observe(record)`` — one drained metrics record (step or
      ft_event); the engine is callable, so ``obs.register(engine)``
      wires it as a flush-time step sink (zero hot-path syncs: records
      arrive already host-converted, every ``flush_every`` steps).
    - ``observe_heartbeats(beats, now)`` — the aggregator/monitor side:
      dead/slow-rank rules over ``read_heartbeats`` output.
    - ``check_bench(now)`` — bench-staleness rules; also run once lazily
      on the first observed record so a trainer-side engine books it.
    - ``emit`` — called once per firing with the ft_event payload; the
      trainers pass ``lambda **f: obs.log_event("alert", **f)``.

    A rule fires once per breach episode (latched), clears when its
    condition goes back under threshold, and may fire again on the next
    breach.  Evaluation errors never propagate into the training loop.
    """

    def __init__(self, rules: Iterable[Rule],
                 emit: Optional[Callable[..., None]] = None,
                 process_index: int = 0):
        self.rules = list(rules)
        self.emit = emit
        self.process_index = int(process_index)
        self.firing: Dict[Any, Alert] = {}
        self.history: List[Alert] = []
        self._by_kind: Dict[str, List[Rule]] = {}
        for r in self.rules:
            self._by_kind.setdefault(r.kind, []).append(r)
        self._event_counts: Dict[str, int] = {}
        self._bench_checked = False
        # live goodput estimate: productive step seconds vs wall span
        self._steps = 0
        self._prod = 0.0
        self._first_st: Optional[float] = None
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    # ------------------------------------------------------------- latching
    def _fire(self, rule: Rule, key: Any, detail: str,
              step: Optional[int] = None, value: Optional[float] = None,
              threshold: Optional[float] = None,
              rank: Optional[int] = None) -> List[Alert]:
        if key in self.firing:
            return []
        alert = Alert(name=rule.name, kind=rule.kind, severity=rule.severity,
                      detail=detail, step=step, value=value,
                      threshold=threshold, rank=rank, t=time.time())
        self.firing[key] = alert
        self.history.append(alert)
        if self.emit is not None:
            try:
                self.emit(**alert.fields())
            except Exception:
                pass  # alerting must never take down the training loop
        return [alert]

    def _clear(self, key: Any) -> None:
        self.firing.pop(key, None)

    def active(self) -> List[Alert]:
        """Currently-firing alerts (latched, condition not yet cleared)."""
        return list(self.firing.values())

    # ------------------------------------------------------------ the stream
    def __call__(self, record: dict) -> None:
        self.observe(record)

    def observe(self, rec: dict) -> List[Alert]:
        """Evaluate one drained record; returns any alerts fired by it."""
        fired: List[Alert] = []
        try:
            if "bench_event" in rec:
                return fired
            if not self._bench_checked:
                self._bench_checked = True
                fired += self.check_bench()
            if "ft_event" in rec:
                return fired + self._observe_event(rec)
            if "step_time" in rec:
                fired += self._observe_step(rec)
        except Exception:
            if self.emit is None:
                raise  # offline/test path: surface the bug
        return fired

    def _observe_event(self, rec: dict) -> List[Alert]:
        kind = str(rec["ft_event"])
        if kind == "alert":
            return []  # never alert on alerts (incl. our own bookings)
        self._event_counts[kind] = self._event_counts.get(kind, 0) + 1
        fired: List[Alert] = []
        if kind == "hang":
            for rule in self._by_kind.get("hang", ()):
                coll = rec.get("collective") or rec.get("kind")
                detail = (f"collective hang at step {rec.get('step')}"
                          + (f" ({coll})" if coll else ""))
                fired += self._fire(rule, key=rule.name, detail=detail,
                                    step=rec.get("step"),
                                    value=rec.get("elapsed_s"))
        elif kind == "replica_down":
            for rule in self._by_kind.get("replica_down", ()):
                rid = rec.get("replica")
                reason = rec.get("reason")
                detail = (f"serving replica {rid} quarantined"
                          + (f" ({reason})" if reason else ""))
                fired += self._fire(rule, key=(rule.name, rid),
                                    detail=detail,
                                    rank=rid if isinstance(rid, int)
                                    else None)
        elif kind == "recompile":
            n = self._event_counts[kind]
            for rule in self._by_kind.get("recompile", ()):
                cap = int(rule.params.get("max_events", 0))
                if n > cap:
                    fired += self._fire(
                        rule, key=rule.name, step=rec.get("step"),
                        value=float(n), threshold=float(cap),
                        detail=f"{n} post-warmup recompile(s) > {cap}")
        return fired

    def _observe_step(self, rec: dict) -> List[Alert]:
        fired: List[Alert] = []
        step = int(rec.get("step", -1))
        proc = int(rec.get("process", self.process_index))
        st = float(rec["step_time"])
        self._steps += 1
        self._prod += st
        if self._first_st is None:
            self._first_st = st
        t = rec.get("t")
        if isinstance(t, (int, float)):
            self._t0 = t if self._t0 is None else min(self._t0, t)
            self._t1 = t if self._t1 is None else max(self._t1, t)

        for rule in self._by_kind.get("step_time_p95", ()):
            q = rule.params.get("quantile", "p95")
            v = rec.get(_QUANTILE_FIELDS[q])
            warmup = int(rule.params.get("warmup_steps", 10))
            if v is None or step < warmup:
                continue
            ms = float(v) * 1e3
            cap = float(rule.params["max_ms"])
            key = (rule.name, proc)
            if ms > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=ms, threshold=cap,
                    rank=proc,
                    detail=f"step time {q} {ms:.1f}ms > {cap:g}ms")
            else:
                self._clear(key)

        for rule in self._by_kind.get("exposed_comm", ()):
            v = rec.get("exposed_comm_ms")
            if v is None:
                continue
            cap = float(rule.params["max_ms"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"exposed comm {float(v):.3f}ms > {cap:g}ms")
            else:
                self._clear(key)

        for rule in self._by_kind.get("ttft_p99", ()):
            v = rec.get("ttft_p99_ms")
            if v is None:
                continue
            cap = float(rule.params["max_ms"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"TTFT p99 {float(v):.1f}ms > {cap:g}ms")
            else:
                self._clear(key)

        for rule in self._by_kind.get("kv_occupancy", ()):
            v = rec.get("kv_occupancy_pct")
            if v is None:
                continue
            cap = float(rule.params["max_pct"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"KV occupancy {float(v):.1f}% > {cap:g}%")
            else:
                self._clear(key)

        for rule in self._by_kind.get("queue_wait_share", ()):
            v = rec.get("queue_wait_share_p99")
            if v is None:
                continue
            cap = float(rule.params["max_pct"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"queue-wait share p99 {float(v):.1f}% of TTFT "
                           f"> {cap:g}%")
            else:
                self._clear(key)

        for rule in self._by_kind.get("preempt_redo", ()):
            v = rec.get("preempt_redo_ms_p99")
            if v is None:
                continue
            cap = float(rule.params["max_ms"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"preempt-redo p99 {float(v):.1f}ms/request "
                           f"> {cap:g}ms")
            else:
                self._clear(key)

        for rule in self._by_kind.get("data_wait_share", ()):
            v = rec.get("data_wait_share")
            warmup = int(rule.params.get("warmup_steps", 5))
            if v is None or step < warmup:
                continue
            cap = float(rule.params["max_pct"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=f"data-wait share {float(v):.1f}% of step time "
                           f"> {cap:g}% — input-starved (loader, not "
                           f"device)")
            else:
                self._clear(key)

        for rule in self._by_kind.get("mem_peak", ()):
            v = rec.get("mem_peak_bytes")
            if v is None:
                continue
            cap = float(rule.params["max_bytes"])
            key = (rule.name, proc)
            if float(v) > cap:
                fired += self._fire(
                    rule, key=key, step=step, value=float(v), threshold=cap,
                    rank=proc,
                    detail=(f"peak HBM {float(v) / 2**20:.1f} MiB > "
                            f"{cap / 2**20:.1f} MiB"))
            else:
                self._clear(key)

        for rule in self._by_kind.get("goodput_floor", ()):
            floor = float(rule.params["min_pct"])
            min_steps = int(rule.params.get("min_steps", 20))
            if (self._steps < min_steps or self._t0 is None
                    or self._t1 is None):
                continue
            wall = (self._t1 - self._t0) + (self._first_st or 0.0)
            if wall <= 0:
                continue
            est = 100.0 * self._prod / wall
            key = rule.name
            if est < floor:
                fired += self._fire(
                    rule, key=key, step=step, value=est, threshold=floor,
                    detail=(f"goodput estimate {est:.1f}% < {floor:g}% "
                            f"over {wall:.1f}s"))
            else:
                self._clear(key)
        return fired

    # -------------------------------------------------------- the heartbeats
    def observe_heartbeats(self, beats: Dict[int, dict],
                           now: Optional[float] = None) -> List[Alert]:
        """Dead/slow-rank rules over one ``read_heartbeats`` snapshot —
        the same ``find_stragglers``/``split_liveness`` thresholds the
        elastic coordinator evicts with (one liveness policy)."""
        fired: List[Alert] = []
        for rule in (list(self._by_kind.get("dead_rank", ()))
                     + list(self._by_kind.get("slow_rank", ()))):
            flagged = find_stragglers(
                beats, now=now,
                max_step_lag=int(rule.params.get("max_step_lag", 3)),
                max_age_s=float(rule.params.get("max_age_s", 60.0)),
                slow_ema_factor=float(
                    rule.params.get("slow_ema_factor", 2.0)))
            dead, slow = _split_liveness(flagged)
            hits = dead if rule.kind == "dead_rank" else slow
            for pid in sorted(beats):
                key = (rule.name, pid)
                if pid in hits:
                    fired += self._fire(
                        rule, key=key, rank=pid,
                        step=beats[pid].get("step"),
                        detail=f"rank {pid}: {flagged[pid]}")
                else:
                    self._clear(key)
        return fired

    # -------------------------------------------------------------- the bench
    def check_bench(self, now: Optional[float] = None) -> List[Alert]:
        """Bench-staleness rules (``bench_staleness`` over the rule's own
        paths): the live twin of the ``obs_report --strict`` stale-bench
        fence."""
        fired: List[Alert] = []
        for rule in self._by_kind.get("bench_stale", ()):
            try:
                info = bench_staleness(lkg_path=rule.params.get("lkg_path"),
                                       events_path=rule.params.get("events_path"),
                                       now=now)
            except Exception:
                continue  # missing/unreadable LKG: nothing to age
            if info is None:
                continue
            days = float(info["days_stale"])
            cap = float(rule.params["max_days"])
            key = rule.name
            if days > cap:
                ev = info.get("stale_events") or 0
                fired += self._fire(
                    rule, key=key, value=days, threshold=cap,
                    detail=(f"benchmark stale {days:.1f} days > {cap:g} "
                            f"(last good {info.get('last_good')}"
                            + (f", {ev} stale event(s)" if ev else "") + ")"))
            else:
                self._clear(key)
        return fired


def evaluate_stream(records: Iterable[dict], rules: Iterable[Rule],
                    beats: Optional[Dict[int, dict]] = None,
                    now: Optional[float] = None) -> AlertEngine:
    """One-shot offline evaluation (tests, CLIs): feed every record, then
    the heartbeat snapshot, then the bench age; returns the engine."""
    engine = AlertEngine(rules)
    for rec in records:
        engine.observe(rec)
    if beats:
        engine.observe_heartbeats(beats, now=now)
    engine._bench_checked = True  # evaluated below with the fixed clock
    engine.check_bench(now=now)
    return engine


# ----------------------------------------------------- stream folding helpers

def alert_events(records: Iterable[dict]) -> List[dict]:
    """The ``alert`` ft_events of a record stream, in order."""
    return [r for r in records if r.get("ft_event") == "alert"]


def dead_ranks_from_events(records: Iterable[dict],
                           since_t: float = 0.0) -> Dict[int, float]:
    """Ranks named by ``dead_rank`` alert events newer than ``since_t``
    → ``{rank: newest event t}``.  This is how ``elastic_agent watch``
    routes a dead-rank alert into the coordinator's one eviction path."""
    out: Dict[int, float] = {}
    for e in alert_events(records):
        if e.get("rule") != "dead_rank" or "rank" not in e:
            continue
        t = float(e.get("t", 0.0))
        if t <= since_t:
            continue
        r = int(e["rank"])
        out[r] = max(out.get(r, 0.0), t)
    return out


def alerts_data(records: Iterable[dict]) -> Dict[str, Any]:
    """Machine-readable fold of a stream's ``alert`` ft_events (the
    ``obs_report --format json`` twin of ``summarize_alerts``)."""
    events = alert_events(records)
    by_name: Dict[str, Dict[str, Any]] = {}
    for e in events:
        name = str(e.get("alert", e.get("rule", "?")))
        slot = by_name.setdefault(name, {
            "count": 0, "rule": e.get("rule"),
            "severity": e.get("severity", "warn"),
            "steps": [], "ranks": [], "last_detail": None, "last_t": None})
        slot["count"] += 1
        if "step" in e:
            slot["steps"].append(e["step"])
        if "rank" in e and e["rank"] not in slot["ranks"]:
            slot["ranks"].append(e["rank"])
        slot["last_detail"] = e.get("detail")
        slot["last_t"] = e.get("t")
    return {"total": len(events), "by_name": by_name}


def summarize_alerts(records: Iterable[dict]) -> List[str]:
    """The ``== alerts ==`` report section: per-rule counts, severity,
    the steps/ranks involved, and the latest detail line."""
    data = alerts_data(records)
    if not data["total"]:
        return []
    lines = ["== alerts =="]
    for name in sorted(data["by_name"]):
        slot = data["by_name"][name]
        bits = [f"[{slot['severity']}]"]
        steps = slot["steps"]
        if steps:
            shown = ",".join(str(s) for s in steps[:6])
            if len(steps) > 6:
                shown += ",…"
            bits.append(f"steps {shown}")
        if slot["ranks"]:
            bits.append("ranks " + ",".join(str(r) for r in slot["ranks"]))
        lines.append(f"  {name:<16}  {slot['count']}x  " + "  ".join(bits))
        if slot["last_detail"]:
            lines.append(f"    {slot['last_detail']}")
    return lines
