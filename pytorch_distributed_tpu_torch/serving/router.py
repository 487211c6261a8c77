"""Resilient fleet router: health-checked dispatch over N serving replicas
— the port of ``pytorch_distributed_tpu/serving/router.py`` (the same wire,
decisions, events and gauges).

Stdlib only, and torch-free at import: it imports the port's torch-free
``obs/{export,heartbeat,reqtrace}.py`` and ``ft/elastic.py`` (the package
``__init__``s load nothing), so ``tools/serve_fleet.py --selftest``, the
router process and the chaoskit kill drills run on a host without paying a
torch import.

The pieces, bottom up:

- ``ReplicaRegistry`` — health-checked membership over the replicas'
  existing ``/healthz`` + ``/metrics`` surface (``ptd_serving_*`` gauges:
  queue depth, kv occupancy, ttft_p99) and ``obs/heartbeat`` beat age.
  Least-loaded ``pick()``; a failing replica is QUARANTINED and re-probed
  with exponential backoff, and the first UP→QUARANTINED transition fires
  ``on_down`` (the router books the ``replica_down`` ft_event + alert).
- ``RouterPolicy`` — the per-request robustness envelope: deadline
  budget, bounded retries with jittered backoff routed to a *different*
  replica, optional tail hedging (duplicate the request after a
  p95-derived delay; the first success cancels the loser).
- ``CompletionLedger`` — exactly-once bookkeeping keyed on rid: the
  first completion wins, replays return the cached result, duplicates
  are counted, never double-delivered.
- ``FleetRouter`` — the HTTP front: ``POST /generate`` (dispatch),
  ``GET /healthz``, ``GET /metrics`` (``ptd_fleet_*`` gauges for
  ``tools/obs_live.py``), ``POST /drain`` (stop admission, let in-flight finish).
- ``decide_scale`` / ``FleetArbiter`` — elastic autoscaling against
  measured SLO headroom, reusing ``ft/elastic.py``'s membership protocol
  (its one eviction path) for grow/shrink; scale events are booked as
  ft_events.

Tracing: a ``TraceContext`` rides every hop.  The router appends
``router:recv`` / ``dispatch:replicaN`` / ``retry:replicaM`` /
``hedge:replicaK`` hops and forwards the wire dict; the winning replica
returns the context extended with its engine-side hops, so one trace
spans router queue → (retries/hedges as sibling hops) → engine admission
→ completion.  Per-request ``fleettrace`` ft_events decompose router
latency into ``router_wait_ms`` / ``redispatch_ms`` / ``hedge_wait_ms``
such that ``router_ttft_ms == router_wait + redispatch + hedge_wait +
engine_ttft_ms`` *exactly*; ``tools/obs_trace.py`` reconciles the echoed
``engine_ttft_ms`` against the replica's own reqtrace record.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pytorch_distributed_tpu_torch.ft import elastic
from pytorch_distributed_tpu_torch.obs import export, heartbeat, reqtrace


# ---------------------------------------------------------------------------
# wire helpers


def http_json(method: str, url: str, payload: Optional[dict],
              timeout: float) -> dict:
    """One JSON request/response round trip; raises on transport failure."""
    data = None
    headers = {"Accept": "application/json"}
    if payload is not None:
        data = json.dumps(payload).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def http_text(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


#: transport-level failures a retry is allowed to absorb.  HTTP error
#: statuses (urllib raises HTTPError, an URLError subclass) are included:
#: a 5xx/503 from a draining or dying replica must route elsewhere.
TRANSPORT_ERRORS = (urllib.error.URLError, ConnectionError, socket.timeout,
                    OSError, json.JSONDecodeError)


# ---------------------------------------------------------------------------
# registry

UP = "UP"
DOWN = "DOWN"
DRAINING = "DRAINING"
QUARANTINED = "QUARANTINED"

REPLICA_STATES = (UP, DOWN, DRAINING, QUARANTINED)


@dataclasses.dataclass
class ReplicaInfo:
    """One replica's registry row: identity, health, and load gauges."""

    rid: int
    base_url: str
    state: str = DOWN               # unknown until the first probe
    failures: int = 0               # consecutive probe/dispatch failures
    backoff_s: float = 0.5          # current quarantine re-probe delay
    next_probe_t: float = 0.0       # monotonic; QUARANTINED gate
    # scraped gauges (None until the first successful probe)
    queue_depth: Optional[float] = None
    kv_occupancy_pct: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    beat_age_s: Optional[float] = None
    # router-side counters
    inflight: int = 0               # attempts currently outstanding
    dispatched: int = 0             # attempts ever sent here
    completed: int = 0              # successes returned from here
    down_count: int = 0             # UP -> QUARANTINED transitions

    def score(self) -> float:
        """Least-loaded dispatch key: in-flight + queued work, with kv
        pressure as the tiebreak-scale term."""
        q = self.queue_depth if self.queue_depth is not None else 0.0
        kv = self.kv_occupancy_pct if self.kv_occupancy_pct is not None else 0.0
        return self.inflight + q + kv / 100.0

    def row(self) -> Dict[str, Any]:
        return {"rid": self.rid, "url": self.base_url, "state": self.state,
                "queue_depth": self.queue_depth,
                "kv_occupancy_pct": self.kv_occupancy_pct,
                "ttft_p99_ms": self.ttft_p99_ms,
                "beat_age_s": self.beat_age_s,
                "inflight": self.inflight, "dispatched": self.dispatched,
                "completed": self.completed, "failures": self.failures}


class ReplicaRegistry:
    """Health-checked replica set with quarantine + backoff re-probe.

    ``probe()`` drives state from three signals: ``/healthz`` (liveness +
    draining flag), scraped ``ptd_serving_*`` gauges (load), and
    heartbeat beat-age from ``hb_dir`` (a wedged process keeps its HTTP
    thread alive; the beat goes stale).  Dispatch failures feed back
    through ``mark_failure`` into the same quarantine path.
    """

    def __init__(self, replicas: Dict[int, str], *, hb_dir: Optional[str] = None,
                 probe_timeout: float = 2.0, backoff_initial_s: float = 0.5,
                 backoff_max_s: float = 30.0, max_beat_age_s: float = 60.0,
                 on_down: Optional[Callable[[ReplicaInfo, str], None]] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.replicas: Dict[int, ReplicaInfo] = {
            int(rid): ReplicaInfo(rid=int(rid), base_url=url.rstrip("/"),
                                  backoff_s=backoff_initial_s)
            for rid, url in replicas.items()}
        self.hb_dir = hb_dir
        self.probe_timeout = float(probe_timeout)
        self.backoff_initial_s = float(backoff_initial_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_beat_age_s = float(max_beat_age_s)
        self.on_down = on_down
        self._now = time_fn
        self._lock = threading.Lock()

    # -- membership -------------------------------------------------------

    def add(self, rid: int, url: str) -> ReplicaInfo:
        with self._lock:
            rep = ReplicaInfo(rid=int(rid), base_url=url.rstrip("/"),
                              backoff_s=self.backoff_initial_s)
            self.replicas[rep.rid] = rep
            return rep

    def remove(self, rid: int) -> None:
        with self._lock:
            self.replicas.pop(int(rid), None)

    # -- health -----------------------------------------------------------

    def probe(self, now: Optional[float] = None) -> None:
        now = self._now() if now is None else now
        beats = {}
        if self.hb_dir:
            beats = heartbeat.read_heartbeats(self.hb_dir)
        wall = time.time()
        for rep in list(self.replicas.values()):
            if rep.state == QUARANTINED and now < rep.next_probe_t:
                continue
            try:
                hz = http_json("GET", rep.base_url + "/healthz", None,
                               self.probe_timeout)
                ok = bool(hz.get("ok"))
                draining = bool(hz.get("draining"))
            except TRANSPORT_ERRORS:
                ok, draining = False, False
            if not ok:
                self._fail(rep, now, "healthz probe failed")
                continue
            try:
                samples = export.parse_prometheus(
                    http_text(rep.base_url + "/metrics", self.probe_timeout))
                rep.queue_depth = export.sample_value(
                    samples, "ptd_serving_queue_depth")
                rep.kv_occupancy_pct = export.sample_value(
                    samples, "ptd_serving_kv_occupancy_pct")
                rep.ttft_p99_ms = export.sample_value(
                    samples, "ptd_serving_ttft_ms", quantile="p99")
            except TRANSPORT_ERRORS:
                pass  # healthy but gauges unreadable: keep last values
            beat = beats.get(rep.rid)
            rep.beat_age_s = (wall - float(beat["t"])) if beat else None
            if (rep.beat_age_s is not None
                    and rep.beat_age_s > self.max_beat_age_s):
                self._fail(rep, now,
                           f"heartbeat stale ({rep.beat_age_s:.0f}s)")
                continue
            rep.state = DRAINING if draining else UP
            rep.failures = 0
            rep.backoff_s = self.backoff_initial_s

    def _fail(self, rep: ReplicaInfo, now: float, reason: str) -> None:
        was_up = rep.state in (UP, DRAINING)
        rep.failures += 1
        rep.state = QUARANTINED
        rep.next_probe_t = now + rep.backoff_s
        rep.backoff_s = min(rep.backoff_s * 2.0, self.backoff_max_s)
        if was_up:
            rep.down_count += 1
            if self.on_down is not None:
                self.on_down(rep, reason)

    def mark_failure(self, rid: int, reason: str = "dispatch failed") -> None:
        rep = self.replicas.get(int(rid))
        if rep is not None:
            self._fail(rep, self._now(), reason)

    def mark_success(self, rid: int) -> None:
        rep = self.replicas.get(int(rid))
        if rep is not None:
            rep.state = UP
            rep.failures = 0
            rep.backoff_s = self.backoff_initial_s

    # -- dispatch ---------------------------------------------------------

    def pick(self, exclude: Sequence[int] = ()) -> Optional[ReplicaInfo]:
        """Least-loaded UP replica not in ``exclude`` (deterministic
        tiebreak on rid)."""
        with self._lock:
            ups = [r for r in self.replicas.values()
                   if r.state == UP and r.rid not in exclude]
            if not ups:
                return None
            return min(ups, key=lambda r: (r.score(), r.rid))

    def up(self) -> List[ReplicaInfo]:
        return [r for r in self.replicas.values() if r.state == UP]

    def quarantined(self) -> List[ReplicaInfo]:
        return [r for r in self.replicas.values() if r.state == QUARANTINED]

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.row() for r in
                    sorted(self.replicas.values(), key=lambda r: r.rid)]


# ---------------------------------------------------------------------------
# policy + ledger


@dataclasses.dataclass
class RouterPolicy:
    """Per-request robustness envelope."""

    deadline_s: float = 30.0        # total budget per request
    max_retries: int = 2            # re-dispatches after the first attempt
    retry_backoff_s: float = 0.05   # base, doubled per retry
    retry_jitter: float = 0.5       # +U(0, jitter) multiplier on backoff
    hedge: bool = False             # arm tail hedging
    hedge_quantile: float = 0.95    # latency quantile deriving the delay
    hedge_min_s: float = 0.02       # floor under the derived delay
    hedge_floor_samples: int = 8    # reservoir size before hedging arms
    seed: int = 0                   # jitter determinism (xor'd with rid)


class CompletionLedger:
    """Exactly-once completion bookkeeping keyed on rid.

    ``book`` returns True only for the first completion of a rid; later
    completions (hedge losers, replays after a router-visible retry
    raced a slow success) are suppressed and counted.  ``get`` serves
    idempotent replay: a client re-sending a completed rid receives the
    original result bit-for-bit.
    """

    def __init__(self, max_entries: int = 65536):
        self.max_entries = int(max_entries)
        self._done: "collections.OrderedDict[int, dict]" = collections.OrderedDict()
        self.duplicates = 0
        self._lock = threading.Lock()

    def book(self, rid: int, result: dict) -> bool:
        with self._lock:
            if rid in self._done:
                self.duplicates += 1
                return False
            self._done[rid] = result
            while len(self._done) > self.max_entries:
                self._done.popitem(last=False)
            return True

    def get(self, rid: int) -> Optional[dict]:
        with self._lock:
            return self._done.get(rid)

    def __len__(self) -> int:
        return len(self._done)


class FleetStats:
    """Router-level counters surfaced as ``ptd_fleet_*`` gauges, the
    periodic fleet step record, and the ``== fleet ==`` report fold."""

    FIELDS = ("requests_routed", "requests_completed", "requests_failed",
              "retries", "hedges", "hedges_won", "hedges_lost",
              "duplicates_suppressed", "replica_down_events",
              "drain_events", "scale_up_events", "scale_down_events")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self.last_scale = "none"

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            d = {f: getattr(self, f) for f in self.FIELDS}
            d["last_scale"] = self.last_scale
            return d


# ---------------------------------------------------------------------------
# router


def _new_ctx(rid: int, t: float):
    return reqtrace.TraceContext(trace_id=f"ptd-router-{rid:08x}", rid=rid,
                                 submit_t=t, hops=["router:0"])


class FleetRouter:
    """HTTP request router over a ``ReplicaRegistry``.

    Call ``submit(payload)`` in-process (drills, selftests) or run
    ``serve()`` for the HTTP surface; both share one dispatch path.
    """

    def __init__(self, registry: ReplicaRegistry,
                 policy: Optional[RouterPolicy] = None, *,
                 obs=None, alert_engine=None,
                 port: int = 0, host: str = "127.0.0.1",
                 probe_interval_s: float = 1.0,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.registry = registry
        self.policy = policy or RouterPolicy()
        self.obs = obs
        self.alert_engine = alert_engine
        self.port = int(port)
        self.host = host
        self.probe_interval_s = float(probe_interval_s)
        self._now = time_fn
        self._sleep = sleep_fn
        self.ledger = CompletionLedger()
        self.stats = FleetStats()
        self.draining = False
        self.inflight = 0
        self._lock = threading.Lock()
        self._latency_ms: collections.deque = collections.deque(maxlen=512)
        self._cycle = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        if registry.on_down is None:
            registry.on_down = self._on_replica_down

    # -- health/bookkeeping ----------------------------------------------

    def _on_replica_down(self, rep: ReplicaInfo, reason: str) -> None:
        """First UP→QUARANTINED transition: book the ft_event + alert."""
        self.stats.bump("replica_down_events")
        if self.obs is not None:
            self.obs.log_event("replica_down", replica=rep.rid,
                               url=rep.base_url, reason=reason)
            if self.alert_engine is not None:
                self.alert_engine.observe(
                    {"ft_event": "replica_down", "replica": rep.rid,
                     "reason": reason, "t": time.time(),
                     "process": self.obs.process_index})

    def log_cycle(self, dt_s: float) -> None:
        """One probe cycle's fleet step record (flush-time sinks see it)."""
        if self.obs is None:
            return
        self._cycle += 1
        d = self.stats.as_dict()
        extra = {"fleet": 1.0,
                 "replicas_up": float(len(self.registry.up())),
                 "replicas_quarantined": float(len(self.registry.quarantined())),
                 "replicas_total": float(len(self.registry.replicas))}
        for f in FleetStats.FIELDS:
            extra[f"fleet_{f}"] = float(d[f])
        routed = max(1, d["requests_routed"])
        extra["retry_rate_pct"] = 100.0 * d["retries"] / routed
        hedges = max(1, d["hedges"])
        extra["hedge_win_rate_pct"] = 100.0 * d["hedges_won"] / hedges
        self.obs.log_step(self._cycle, max(dt_s, 1e-9), extra=extra)

    # -- hedging ----------------------------------------------------------

    def _hedge_delay(self) -> Optional[float]:
        """p95-ish delay from the completed-latency reservoir; None until
        the reservoir has enough samples to trust."""
        if not self.policy.hedge:
            return None
        lat = sorted(self._latency_ms)
        if len(lat) < self.policy.hedge_floor_samples:
            return None
        q = min(max(self.policy.hedge_quantile, 0.0), 1.0)
        idx = min(len(lat) - 1, int(q * len(lat)))
        return max(self.policy.hedge_min_s, lat[idx] / 1000.0)

    # -- dispatch ---------------------------------------------------------

    def _call_replica(self, rep: ReplicaInfo, payload: dict, ctx,
                      timeout: float) -> Tuple[bool, dict]:
        body = dict(payload)
        body["ctx"] = ctx.to_wire()
        rep.inflight += 1
        rep.dispatched += 1
        try:
            resp = http_json("POST", rep.base_url + "/generate", body,
                             max(0.05, timeout))
            if not resp.get("ok"):
                return False, {"error": resp.get("error", "replica refused")}
            rep.completed += 1
            self.registry.mark_success(rep.rid)
            return True, resp
        except TRANSPORT_ERRORS as e:
            self.registry.mark_failure(rep.rid, f"dispatch: {e!r}")
            return False, {"error": repr(e)}
        finally:
            rep.inflight -= 1

    def submit(self, payload: dict) -> Tuple[int, dict]:
        """Dispatch one request; returns ``(http_status, response_dict)``."""
        try:
            rid = int(payload["rid"])
        except (KeyError, TypeError, ValueError):
            return 400, {"ok": False, "error": "missing/invalid rid"}
        with self._lock:
            if self.draining:
                return 503, {"ok": False, "error": "router draining"}
            self.inflight += 1
        try:
            return self._dispatch(payload, rid)
        finally:
            with self._lock:
                self.inflight -= 1

    def _dispatch(self, payload: dict, rid: int) -> Tuple[int, dict]:
        t0 = self._now()
        cached = self.ledger.get(rid)
        if cached is not None:
            self.stats.bump("duplicates_suppressed")
            out = dict(cached)
            out["replayed"] = True
            return 200, out
        self.stats.bump("requests_routed")
        policy = self.policy
        if payload.get("ctx"):
            ctx = reqtrace.TraceContext.from_wire(payload["ctx"])
        else:
            ctx = _new_ctx(rid, t0)
        ctx.hops.append("router:recv")
        deadline = t0 + policy.deadline_s
        rng = random.Random(policy.seed ^ (rid * 0x9E3779B1))
        tried: set = set()
        attempts = 0
        router_wait_ms: Optional[float] = None
        redispatch_ms = 0.0
        last_err = "no replica available"
        while self._now() < deadline and attempts <= policy.max_retries:
            rep = self.registry.pick(exclude=tried)
            if rep is None and tried:
                # every distinct replica tried: allow a second lap rather
                # than failing a request the fleet could still serve.
                rep = self.registry.pick()
            if rep is None:
                self._sleep(min(0.05, max(0.0, deadline - self._now())))
                self.registry.probe()
                continue
            attempt_start = self._now()
            if router_wait_ms is None:
                router_wait_ms = (attempt_start - t0) * 1000.0
            ctx.hops.append(("dispatch" if attempts == 0 else "retry")
                            + f":replica{rep.rid}")
            if attempts > 0:
                self.stats.bump("retries")
            attempts += 1
            ok, res, hedge_wait_ms, won_rep = self._attempt_with_hedge(
                rep, payload, ctx, deadline, tried)
            if ok:
                return self._complete(payload, rid, t0, ctx, res, won_rep,
                                      attempts, router_wait_ms,
                                      redispatch_ms, hedge_wait_ms)
            last_err = res.get("error", "attempt failed")
            tried.add(rep.rid)
            redispatch_ms += (self._now() - attempt_start) * 1000.0
            backoff = (policy.retry_backoff_s * (2 ** (attempts - 1))
                       * (1.0 + rng.random() * policy.retry_jitter))
            wait = min(backoff, max(0.0, deadline - self._now()))
            if wait > 0:
                self._sleep(wait)
                redispatch_ms += wait * 1000.0
        self.stats.bump("requests_failed")
        return 504, {"ok": False, "rid": rid, "error": last_err,
                     "attempts": attempts,
                     "deadline_exceeded": self._now() >= deadline}

    def _attempt_with_hedge(self, rep: ReplicaInfo, payload: dict, ctx,
                            deadline: float, tried: set):
        """One attempt, optionally shadowed by a tail hedge.

        Returns ``(ok, result, hedge_wait_ms, winner_replica)`` where
        ``hedge_wait_ms`` is the time the winning *hedge* spent waiting
        to launch (0 when the primary wins — the decomposition stays
        exact)."""
        results: Queue = Queue()
        budget = max(0.05, deadline - self._now())

        def run(target: ReplicaInfo, is_hedge: bool):
            ok, res = self._call_replica(target, payload, ctx, budget)
            results.put((ok, res, target, is_hedge))

        t_launch = self._now()
        threading.Thread(target=run, args=(rep, False), daemon=True).start()
        outstanding = 1
        hedge_rep: Optional[ReplicaInfo] = None
        hedge_wait_ms = 0.0
        delay = self._hedge_delay()
        if delay is not None:
            try:
                first = results.get(timeout=min(delay, budget))
                outstanding -= 1
                return self._settle(first, None, results, outstanding)
            except Empty:
                hedge_rep = self.registry.pick(
                    exclude=tried | {rep.rid})
                if hedge_rep is not None:
                    hedge_wait_ms = (self._now() - t_launch) * 1000.0
                    ctx.hops.append(f"hedge:replica{hedge_rep.rid}")
                    self.stats.bump("hedges")
                    threading.Thread(target=run, args=(hedge_rep, True),
                                     daemon=True).start()
                    outstanding += 1
        while outstanding > 0 and self._now() < deadline + 1.0:
            try:
                got = results.get(timeout=max(0.05,
                                              deadline + 1.0 - self._now()))
            except Empty:
                break
            outstanding -= 1
            ok, res, target, is_hedge = got
            if ok:
                return self._settle(got, hedge_rep, results, outstanding,
                                    hedge_wait_ms=hedge_wait_ms)
            if outstanding == 0:
                return False, res, 0.0, None
        return False, {"error": "attempt timed out"}, 0.0, None

    def _settle(self, winner, hedge_rep, results: Queue, outstanding: int,
                hedge_wait_ms: float = 0.0):
        ok, res, target, is_hedge = winner
        if hedge_rep is not None:
            self.stats.bump("hedges_won" if is_hedge else "hedges_lost")
            # first winner cancels the loser (best-effort; the ledger
            # suppresses a loser that completes anyway).
            loser_rep = (hedge_rep if not is_hedge else None)
            self._cancel_loser(res.get("rid"), loser_rep, results, outstanding)
        return ok, res, (hedge_wait_ms if is_hedge else 0.0), target

    def _cancel_loser(self, rid, loser_rep: Optional[ReplicaInfo],
                      results: Queue, outstanding: int) -> None:
        """POST /cancel to whichever replica still holds the duplicate."""
        targets = ([loser_rep] if loser_rep is not None
                   else list(self.registry.up()))
        def _go():
            for t in targets:
                try:
                    http_json("POST", t.base_url + "/cancel",
                              {"rid": rid}, 1.0)
                except TRANSPORT_ERRORS:
                    pass
            # drain the loser's eventual result so the queue thread exits
            for _ in range(outstanding):
                try:
                    results.get(timeout=5.0)
                except Empty:
                    break
        threading.Thread(target=_go, daemon=True).start()

    def _complete(self, payload: dict, rid: int, t0: float, ctx, res,
                  won_rep: Optional[ReplicaInfo], attempts: int,
                  router_wait_ms: float, redispatch_ms: float,
                  hedge_wait_ms: float) -> Tuple[int, dict]:
        now = self._now()
        router_e2e_ms = (now - t0) * 1000.0
        self._latency_ms.append(router_e2e_ms)
        # the winning replica returns the forwarded context extended with
        # its engine-side hops: adopt it so the final chain is one trace.
        if res.get("ctx"):
            try:
                ctx = reqtrace.TraceContext.from_wire(res["ctx"])
            except (KeyError, TypeError, ValueError):
                pass
        ctx.hops.append("router:done")
        engine_ttft_ms = float(res.get("ttft_ms", 0.0))
        engine_e2e_ms = float(res.get("e2e_ms", 0.0))
        # the parts at the 4 decimals they are logged with, summed in the
        # order a reader sums them: the logged identity holds bit for bit
        # (summing unrounded parts and rounding the total, as the JAX
        # router does, drifts by up to 1e-4 ms once a retry books
        # redispatch time).
        router_wait_ms = round(router_wait_ms, 4)
        redispatch_ms = round(redispatch_ms, 4)
        hedge_wait_ms = round(hedge_wait_ms, 4)
        router_ttft_ms = (router_wait_ms + redispatch_ms + hedge_wait_ms
                          + engine_ttft_ms)
        out = {"ok": True, "rid": rid, "tokens": res.get("tokens", []),
               "replica": won_rep.rid if won_rep else res.get("replica"),
               "attempts": attempts, "hedged": hedge_wait_ms > 0.0,
               "cached": bool(res.get("cached")),
               "ttft_ms": engine_ttft_ms, "e2e_ms": engine_e2e_ms,
               "router_ttft_ms": router_ttft_ms,
               "router_e2e_ms": router_e2e_ms,
               "ctx": ctx.to_wire()}
        first = self.ledger.book(rid, out)
        if not first:
            self.stats.bump("duplicates_suppressed")
            prior = self.ledger.get(rid)
            replay = dict(prior)
            replay["replayed"] = True
            return 200, replay
        self.stats.bump("requests_completed")
        if self.obs is not None:
            self.obs.log_event(
                "fleettrace", rid=rid, trace_id=ctx.trace_id,
                replica=out["replica"], attempts=attempts,
                hedged=int(out["hedged"]),
                router_wait_ms=router_wait_ms,
                redispatch_ms=redispatch_ms,
                hedge_wait_ms=hedge_wait_ms,
                engine_ttft_ms=round(engine_ttft_ms, 4),
                engine_e2e_ms=round(engine_e2e_ms, 4),
                router_ttft_ms=router_ttft_ms,
                router_e2e_ms=round(router_e2e_ms, 4),
                ctx=json.dumps(ctx.to_wire()))
        return 200, out

    # -- drain ------------------------------------------------------------

    def drain(self, wait: bool = False, timeout_s: float = 30.0) -> dict:
        with self._lock:
            self.draining = True
        self.stats.bump("drain_events")
        if self.obs is not None:
            self.obs.log_event("drain", scope="router",
                               inflight=self.inflight)
        if wait:
            t_end = self._now() + timeout_s
            while self.inflight > 0 and self._now() < t_end:
                self._sleep(0.01)
        return {"ok": True, "draining": True, "inflight": self.inflight}

    # -- metrics ----------------------------------------------------------

    def render_metrics(self) -> str:
        return render_fleet_metrics(self.registry, self.stats,
                                    draining=self.draining,
                                    inflight=self.inflight)

    # -- HTTP surface ------------------------------------------------------

    def start(self) -> None:
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    ok = not router.draining and bool(router.registry.up())
                    self._send(200 if ok else 503, json.dumps(
                        {"ok": ok, "role": "router",
                         "draining": router.draining,
                         "replicas_up": len(router.registry.up())}))
                elif self.path.startswith("/metrics"):
                    self._send(200, router.render_metrics(),
                               "text/plain; version=0.0.4")
                elif self.path.startswith("/stats"):
                    self._send(200, json.dumps(
                        {"stats": router.stats.as_dict(),
                         "replicas": router.registry.snapshot(),
                         "ledger": len(router.ledger)}))
                else:
                    self._send(404, json.dumps({"ok": False}))

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, json.dumps(
                        {"ok": False, "error": "bad json"}))
                    return
                if self.path.startswith("/generate"):
                    code, body = router.submit(payload)
                    self._send(code, json.dumps(body))
                elif self.path.startswith("/drain"):
                    self._send(200, json.dumps(router.drain(
                        wait=bool(payload.get("wait")))))
                else:
                    self._send(404, json.dumps({"ok": False}))

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        probe = threading.Thread(target=self._probe_loop, daemon=True)
        probe.start()
        self._threads.append(probe)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            t0 = self._now()
            try:
                self.registry.probe()
            except Exception:
                pass
            self.log_cycle(self._now() - t0)
            self._stop.wait(self.probe_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def render_fleet_metrics(registry: ReplicaRegistry, stats: FleetStats, *,
                         draining: bool = False, inflight: int = 0) -> str:
    """Prometheus exposition for the router (``ptd_fleet_*`` namespace —
    names pinned in ``obs/export.py`` ``FLEET_GAUGES``)."""

    def line(name, labels, value):
        if not labels:
            return f"{name} {float(value):g}"
        return export._line(name, labels, value)

    out = [line("ptd_fleet_up", {}, 0.0 if draining else 1.0),
           line("ptd_fleet_inflight", {}, float(inflight))]
    d = stats.as_dict()
    out.append(line("ptd_fleet_requests_total", {},
                    float(d["requests_routed"])))
    out.append(line("ptd_fleet_completed_total", {},
                    float(d["requests_completed"])))
    out.append(line("ptd_fleet_failed_total", {},
                    float(d["requests_failed"])))
    out.append(line("ptd_fleet_retries_total", {}, float(d["retries"])))
    out.append(line("ptd_fleet_hedges_total", {}, float(d["hedges"])))
    out.append(line("ptd_fleet_hedges_won_total", {},
                    float(d["hedges_won"])))
    out.append(line("ptd_fleet_hedges_lost_total", {},
                    float(d["hedges_lost"])))
    out.append(line("ptd_fleet_duplicates_suppressed_total", {},
                    float(d["duplicates_suppressed"])))
    out.append(line("ptd_fleet_replica_down_total", {},
                    float(d["replica_down_events"])))
    out.append(line("ptd_fleet_last_scale", {"decision": d["last_scale"]},
                    1.0))
    rows = registry.snapshot()
    out.append(line("ptd_fleet_replicas", {}, float(len(rows))))
    out.append(line("ptd_fleet_quarantined", {},
                    float(sum(1 for r in rows if r["state"] == QUARANTINED))))
    for r in rows:
        lbl = {"replica": str(r["rid"])}
        out.append(line("ptd_fleet_replica_state",
                        {**lbl, "state": r["state"]}, 1.0))
        for field, gauge in (
                ("queue_depth", "ptd_fleet_replica_queue_depth"),
                ("kv_occupancy_pct", "ptd_fleet_replica_kv_occupancy_pct"),
                ("ttft_p99_ms", "ptd_fleet_replica_ttft_p99_ms"),
                ("beat_age_s", "ptd_fleet_replica_beat_age_seconds")):
            if r[field] is not None:
                out.append(line(gauge, lbl, float(r[field])))
        out.append(line("ptd_fleet_replica_dispatched_total", lbl,
                        float(r["dispatched"])))
        out.append(line("ptd_fleet_replica_completed_total", lbl,
                        float(r["completed"])))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# elastic autoscaling


def decide_scale(rows: List[Dict[str, Any]], *, slo_ttft_ms: float,
                 scale_up_pct: float = 85.0, scale_down_pct: float = 30.0,
                 min_replicas: int = 1, max_replicas: int = 8,
                 queue_hi: float = 8.0) -> Tuple[Optional[str],
                                                 Optional[int], str]:
    """Pure scale decision from registry snapshot rows.

    Headroom is measured as worst-replica ``ttft_p99`` against the SLO
    (plus a queue-depth pressure valve).  Returns ``(decision,
    victim_rid, reason)`` where decision is ``"up"``, ``"down"`` or
    ``None`` and ``victim_rid`` names the least-loaded UP replica when
    shrinking.
    """
    ups = [r for r in rows if r["state"] == UP]
    n = len(rows)
    if not ups:
        if n < max_replicas:
            return "up", None, "no UP replicas: grow to restore capacity"
        return None, None, "no UP replicas and at max_replicas"
    ttfts = [r["ttft_p99_ms"] for r in ups if r["ttft_p99_ms"] is not None]
    queues = [r["queue_depth"] or 0.0 for r in ups]
    worst_pct = (100.0 * max(ttfts) / slo_ttft_ms) if ttfts else 0.0
    worst_q = max(queues) if queues else 0.0
    if (worst_pct > scale_up_pct or worst_q > queue_hi) and n < max_replicas:
        return ("up", None,
                f"SLO headroom exhausted: ttft_p99 at {worst_pct:.0f}% of "
                f"SLO, max queue {worst_q:.0f}")
    if worst_pct < scale_down_pct and worst_q == 0.0 and len(ups) > min_replicas:
        victim = min(ups, key=lambda r: ((r["queue_depth"] or 0.0)
                                         + (r["inflight"] or 0), r["rid"]))
        return ("down", victim["rid"],
                f"SLO headroom ample: ttft_p99 at {worst_pct:.0f}% of SLO, "
                f"queues empty")
    return None, None, f"hold: ttft_p99 at {worst_pct:.0f}% of SLO"


class FleetArbiter:
    """Elastic replica-set arbiter.

    Reuses ``ft/elastic.py``'s membership protocol verbatim: replicas
    beat into ``hb_dir``, membership lives in ``membership.json``, and
    scale-downs/evictions go through ``ElasticCoordinator.decide``'s one
    eviction path (``extra_dead``), as the alert-driven eviction does.
    Scale events are booked as ft_events.
    """

    def __init__(self, registry: ReplicaRegistry, hb_dir: str, *,
                 slo_ttft_ms: float = 500.0, min_replicas: int = 1,
                 max_replicas: int = 8, scale_up_pct: float = 85.0,
                 scale_down_pct: float = 30.0, obs=None,
                 spawn_cb: Optional[Callable[[int], Optional[str]]] = None,
                 drain_cb: Optional[Callable[[int], bool]] = None,
                 stats: Optional[FleetStats] = None,
                 dead_failures: int = 2,
                 time_fn: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.hb_dir = hb_dir
        self.slo_ttft_ms = float(slo_ttft_ms)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_pct = float(scale_up_pct)
        self.scale_down_pct = float(scale_down_pct)
        self.obs = obs
        self.spawn_cb = spawn_cb
        self.drain_cb = drain_cb
        self.stats = stats or FleetStats()
        self.dead_failures = int(dead_failures)
        self._now = time_fn
        self.co = elastic.ElasticCoordinator(
            hb_dir, world=max(len(registry.replicas), self.min_replicas, 1),
            min_ranks=self.min_replicas)
        # a fresh membership file defaults to range(world); the fleet's
        # identities are replica ids, so bootstrap epoch 0 to match.
        want = sorted(registry.replicas)
        m = self.co.membership()
        if want and m.epoch == 0 and set(m.ranks) != set(want):
            elastic.atomic_write_json(
                self.co.path,
                elastic.Membership(epoch=0, ranks=tuple(want)).to_json())

    def _book(self, kind: str, **fields) -> None:
        if self.obs is not None:
            self.obs.log_event(kind, **fields)

    def evict_dead(self) -> List[int]:
        """Quarantined-beyond-doubt replicas leave the membership through
        the coordinator's one eviction path."""
        members = set(self.co.membership().ranks)
        dead = {r.rid: f"replica_down x{r.failures}"
                for r in self.registry.quarantined()
                if r.failures >= self.dead_failures and r.rid in members}
        if not dead:
            return []
        change = self.co.decide(extra_dead=dead)
        if change is None:
            return []
        evicted = sorted(set(change.old.ranks) - set(change.new.ranks))
        for rid in evicted:
            self._book("replica_evict", replica=rid,
                       reason=dead.get(rid, ""), epoch=change.new.epoch)
        return evicted

    def cycle(self) -> Tuple[Optional[str], str]:
        """One arbiter pass: probe, evict the dead, then scale on
        measured headroom.  Returns ``(decision, reason)``."""
        self.registry.probe()
        self.evict_dead()
        rows = self.registry.snapshot()
        live_rows = [r for r in rows
                     if r["rid"] in set(self.co.membership().ranks)
                     or r["state"] == UP]
        decision, victim, reason = decide_scale(
            live_rows, slo_ttft_ms=self.slo_ttft_ms,
            scale_up_pct=self.scale_up_pct,
            scale_down_pct=self.scale_down_pct,
            min_replicas=self.min_replicas, max_replicas=self.max_replicas)
        if decision == "up":
            new_rid = (max(self.registry.replicas) + 1
                       if self.registry.replicas else 0)
            url = self.spawn_cb(new_rid) if self.spawn_cb else None
            if url:
                self.registry.add(new_rid, url)
                self.co.request_join(new_rid)
                self.co.decide()
                self.stats.bump("scale_up_events")
                self.stats.last_scale = f"up:replica{new_rid}"
                self._book("scale_up", replica=new_rid, url=url,
                           reason=reason)
            else:
                decision = None
                reason += " (no spawn capacity)"
        elif decision == "down" and victim is not None:
            drained = self.drain_cb(victim) if self.drain_cb else True
            if drained:
                change = self.co.decide(
                    extra_dead={victim: "scale_down drain"})
                self.registry.remove(victim)
                self.stats.bump("scale_down_events")
                self.stats.bump("drain_events")
                self.stats.last_scale = f"down:replica{victim}"
                self._book("scale_down", replica=victim, reason=reason,
                           epoch=(change.new.epoch if change else -1))
            else:
                decision = None
                reason += " (drain refused)"
        return decision, reason
