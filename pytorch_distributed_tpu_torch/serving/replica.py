"""Serving replica: the fleet-facing HTTP wrapper around one engine — the
port of ``pytorch_distributed_tpu/serving/replica.py`` (the same wire).

``ReplicaServer`` puts a small JSON surface in front of a backend:

- ``POST /generate`` — synchronous decode; forwarded ``TraceContext``
  wire dicts gain replica-side hops and ride back on the response.
  Completed results are cached by rid, so a replay (router retry after
  a lost response, or a restarted router re-dispatching) returns the
  original tokens bit-for-bit without recomputing — the replica half of
  the fleet's exactly-once story.
- ``GET /healthz`` / ``GET /metrics`` — the same liveness + ``ptd_serving_*``
  gauge surface ``serve_lm`` exports, so the router's registry scrapes
  replicas uniformly.
- ``POST /drain`` — stop admission, let in-flight lanes finish, then
  flag drained (the arbiter deregisters after).
- ``POST /cancel`` — best-effort abort of an in-flight rid (hedge
  losers); a cancelled request is *not* cached, a later replay
  recomputes.

Two backends share the ``generate``/``cancel``/``stats_record`` duck
type:

- ``SimEngineBackend`` — torch-free, deterministic stand-in:
  tokens are a pure function of ``(prompt, seed)`` (``sim_tokens``), so
  two replicas with the same seed produce bit-identical outputs — the
  property the replica-kill drill's bit-exactness fence measures
  end-to-end.  Lanes are handler threads gated by a ``max_batch``
  semaphore with real (sleep-based) prefill/ITL costs, so queue depth,
  TTFT tails, and replica-for-replica throughput scaling behave
  honestly on a 1-core CI host.
- ``EngineBackend`` — the port's ``ServingEngine`` behind the same wire
  (torch imported when it is built), on ``device`` (``cuda`` unless the
  caller asks for ``cpu``; no card raises), driven by a background step
  thread.

The module imports no torch: the router and the sim replicas run without
it.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from pytorch_distributed_tpu_torch.obs import export, heartbeat, reqtrace


def sim_tokens(prompt: List[int], n: int, vocab: int, seed: int) -> List[int]:
    """Deterministic pseudo-decode: a pure function of (prompt, seed).

    Every replica with the same seed emits the same tokens for the same
    prompt — the invariant that lets the kill drill assert bit-exact
    outputs across a redispatch to a different replica.
    """
    h = (seed * 0x9E3779B1 + 0x85EBCA6B) & 0xFFFFFFFF
    for t in prompt:
        h = (h * 1000003 ^ (int(t) + 0x9E37)) & 0xFFFFFFFF
    out = []
    for i in range(n):
        h = (h * 1103515245 + 12345 + i) & 0xFFFFFFFF
        out.append((h >> 7) % max(1, vocab))
    return out


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class SimEngineBackend:
    """Deterministic torch-free engine stand-in with honest queueing.

    ``max_batch`` lanes are a semaphore; a request waits (queue), takes
    a lane (admit), pays ``len(prompt) * prefill_ms_per_token`` of
    prefill, then one ``itl_ms`` sleep per token after the first.  All
    sleeps release the GIL, so N replicas on one host scale close to
    linearly until cores saturate — the property the bench fences.
    """

    def __init__(self, *, replica_id: int = 0, vocab_size: int = 64,
                 max_batch: int = 4, prefill_ms_per_token: float = 0.2,
                 itl_ms: float = 2.0, seed: int = 0,
                 slo_ttft_ms: Optional[float] = None, obs=None,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.replica_id = int(replica_id)
        self.vocab_size = int(vocab_size)
        self.max_batch = int(max_batch)
        self.prefill_ms_per_token = float(prefill_ms_per_token)
        self.itl_ms = float(itl_ms)
        self.seed = int(seed)
        self.slo_ttft_ms = slo_ttft_ms
        self.obs = obs
        self._now = time_fn
        self._sleep = sleep_fn
        self._sem = threading.Semaphore(self.max_batch)
        self._lock = threading.Lock()
        self._queued = 0
        self._active = 0
        self.completed = 0
        self.cancelled = 0
        self.tokens_total = 0
        self._ttft_ms: collections.deque = collections.deque(maxlen=512)
        self._e2e_ms: collections.deque = collections.deque(maxlen=512)
        self._cancel: Dict[int, threading.Event] = {}
        self.t0 = self._now()

    def cancel(self, rid: int) -> bool:
        ev = self._cancel.get(int(rid))
        if ev is None:
            return False
        ev.set()
        return True

    def generate(self, rid: int, prompt: List[int], max_new_tokens: int,
                 ctx=None) -> Dict[str, Any]:
        submit = self._now()
        cancel_ev = threading.Event()
        with self._lock:
            self._queued += 1
            self._cancel[int(rid)] = cancel_ev
        if ctx is not None:
            ctx.hops.append("queue")
        self._sem.acquire()
        admit = self._now()
        with self._lock:
            self._queued -= 1
            self._active += 1
        try:
            if ctx is not None:
                ctx.hops.append("admit")
            self._sleep(len(prompt) * self.prefill_ms_per_token / 1000.0)
            first = self._now()
            toks = sim_tokens(prompt, int(max_new_tokens), self.vocab_size,
                              self.seed)
            emitted: List[int] = []
            for i, tok in enumerate(toks):
                if cancel_ev.is_set():
                    self.cancelled += 1
                    return {"ok": False, "rid": rid, "error": "cancelled",
                            "cancelled": True}
                if i > 0:
                    self._sleep(self.itl_ms / 1000.0)
                emitted.append(tok)
            finish = self._now()
            ttft_ms = (first - submit) * 1000.0
            e2e_ms = (finish - submit) * 1000.0
            with self._lock:
                self.completed += 1
                self.tokens_total += len(emitted)
                self._ttft_ms.append(ttft_ms)
                self._e2e_ms.append(e2e_ms)
            if ctx is not None:
                ctx.hops.append("finish")
            self._book_trace(rid, ctx, submit, admit, first, ttft_ms,
                             e2e_ms, len(emitted))
            return {"ok": True, "rid": rid, "tokens": emitted,
                    "ttft_ms": round(ttft_ms, 4), "e2e_ms": round(e2e_ms, 4)}
        finally:
            with self._lock:
                self._active -= 1
                self._cancel.pop(int(rid), None)
            self._sem.release()

    def _book_trace(self, rid: int, ctx, submit: float, admit: float,
                    first: float, ttft_ms: float, e2e_ms: float,
                    tokens: int) -> None:
        """Book a reqtrace-shaped completion event so ``obs_trace`` can
        reconcile the router's echoed ``engine_ttft_ms`` against the
        replica's own record — exact TTFT decomposition included
        (``other_wait_ms`` soaks float ulps, keeping recon err at 0)."""
        if self.obs is None:
            return
        queue_wait_ms = (admit - submit) * 1000.0
        prefill_ms = (first - admit) * 1000.0
        other_wait_ms = ttft_ms - queue_wait_ms - prefill_ms
        violated = int(self.slo_ttft_ms is not None
                       and ttft_ms > self.slo_ttft_ms)
        trace_id = (ctx.trace_id if ctx is not None
                    else f"ptd-engine:{self.replica_id}-{rid:08x}")
        self.obs.log_event(
            "reqtrace", rid=rid, trace_id=trace_id,
            submit_t=round(submit, 6), ttft_ms=round(ttft_ms, 4),
            e2e_ms=round(e2e_ms, 4), tokens=tokens, preemptions=0,
            queue_wait_ms=round(queue_wait_ms, 4),
            prefill_ms=round(prefill_ms, 4),
            redo_wait_ms=0.0, defrag_wait_ms=0.0,
            other_wait_ms=round(other_wait_ms, 4),
            decode_ms=round(e2e_ms - ttft_ms, 4),
            redo_own_ms=0.0, defrag_run_ms=0.0, other_run_ms=0.0,
            preempt_redo_ms=0.0,
            queue_wait_share_pct=round(
                100.0 * queue_wait_ms / max(ttft_ms, 1e-9), 2),
            violated=violated, n_spans=0, spans_dropped=0, sampled=0,
            ctx=json.dumps(ctx.to_wire()) if ctx is not None else "")

    def stats_record(self) -> Dict[str, float]:
        with self._lock:
            ttft = sorted(self._ttft_ms)
            queued = float(self._queued)
            active = float(self._active)
            completed = float(self.completed)
            tokens = float(self.tokens_total)
        wall = max(self._now() - self.t0, 1e-9)
        return {"queue_depth": queued, "active_seqs": active,
                "kv_occupancy_pct": 100.0 * active / self.max_batch,
                "ttft_p50_ms": _quantile(ttft, 0.50),
                "ttft_p95_ms": _quantile(ttft, 0.95),
                "ttft_p99_ms": _quantile(ttft, 0.99),
                "requests_completed": completed,
                "tokens_per_s": tokens / wall}

    def close(self) -> None:
        pass


class EngineBackend:
    """The port's ``ServingEngine`` behind the replica wire.

    A background thread steps the engine whenever it has queued or
    active work; ``generate`` submits and blocks on completion.  Cancel
    is unsupported here (the ledger/rid-cache still guarantee a hedge
    loser is never double-delivered — it just runs to completion).
    """

    def __init__(self, *, replica_id: int = 0, vocab_size: int = 64,
                 d_model: int = 32, n_heads: int = 4, n_layers: int = 2,
                 max_batch: int = 4, kv_blocks: int = 64,
                 block_size: int = 16, blocks_per_seq: int = 8,
                 chunk_size: int = 8, max_new_tokens: int = 16,
                 seed: int = 0, obs=None, trace=None, device="cuda"):
        from pytorch_distributed_tpu_torch.serving.engine import (
            ServingEngine,
            init_lm_params,
        )
        from pytorch_distributed_tpu_torch.serving.scheduler import Request
        self.replica_id = int(replica_id)
        self._Request = Request
        params = init_lm_params(vocab_size, d_model, n_heads, n_layers,
                                seed=seed, device=device)
        self.eng = ServingEngine(
            params, vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
            n_layers=n_layers, max_batch=max_batch, kv_blocks=kv_blocks,
            block_size=block_size, blocks_per_seq=blocks_per_seq,
            chunk_size=chunk_size, max_new_tokens=max_new_tokens,
            obs=obs, trace=trace, seed=seed, device=device)
        del params
        self.obs = obs
        self.completed = 0
        self.cancelled = 0
        self._lock = threading.Lock()
        self._done: Dict[int, threading.Event] = {}
        self._reqs: Dict[int, Any] = {}
        self._seen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._step_loop, daemon=True)
        self._thread.start()

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            busy = False
            with self._lock:
                if self.eng.sched.active or self.eng.sched.queue_depth:
                    self.eng.step()
                    busy = True
                for req in self.eng.finished[self._seen:]:
                    self._seen += 1
                    ev = self._done.get(req.rid)
                    if ev is not None:
                        ev.set()
            if not busy:
                time.sleep(0.002)

    def cancel(self, rid: int) -> bool:  # noqa: ARG002
        return False

    def generate(self, rid: int, prompt: List[int], max_new_tokens: int,
                 ctx=None) -> Dict[str, Any]:
        ev = threading.Event()
        with self._lock:
            req = self._Request(rid=int(rid), prompt=list(prompt),
                                max_new_tokens=int(max_new_tokens),
                                arrival_time=time.monotonic(),
                                trace_ctx=ctx)
            self._done[int(rid)] = ev
            self._reqs[int(rid)] = req
            self.eng.submit(req)
        ev.wait(timeout=600.0)
        with self._lock:
            self._done.pop(int(rid), None)
            self._reqs.pop(int(rid), None)
        if req.finish_time is None:
            return {"ok": False, "rid": rid, "error": "engine timeout"}
        self.completed += 1
        ttft_ms = 1000.0 * ((req.first_token_time or req.arrival_time)
                            - req.arrival_time)
        e2e_ms = 1000.0 * (req.finish_time - req.arrival_time)
        # graft engine-side hops onto the forwarded context: submit()
        # replaces trace_ctx when a tracer is armed, so the wire chain
        # is forwarded hops + whatever the engine recorded.
        if ctx is not None and req.trace_ctx is not None \
                and req.trace_ctx is not ctx:
            ctx.hops.extend(req.trace_ctx.hops)
        return {"ok": True, "rid": rid,
                "tokens": [int(t) for t in req.generated],
                "ttft_ms": round(ttft_ms, 4), "e2e_ms": round(e2e_ms, 4)}

    def stats_record(self) -> Dict[str, float]:
        with self._lock:
            q = float(self.eng.sched.queue_depth)
            active = float(len(self.eng.sched.active))
            occ = float(self.eng.pool.occupancy_pct())
        ttft = sorted(1000.0 * ((r.first_token_time or 0.0) - r.arrival_time)
                      for r in self.eng.finished if r.first_token_time)
        s = self.eng.summary() if self.eng.finished else {}
        return {"queue_depth": q, "active_seqs": active,
                "kv_occupancy_pct": occ,
                "ttft_p50_ms": _quantile(ttft, 0.50),
                "ttft_p95_ms": _quantile(ttft, 0.95),
                "ttft_p99_ms": _quantile(ttft, 0.99),
                "requests_completed": float(len(self.eng.finished)),
                "tokens_per_s": float(s.get("tokens_per_s", 0.0))}

    def kernel_launches(self) -> Dict[str, int]:
        """This process's launches of each hand-written kernel since it
        started, by wrapper (the ``launches`` count of ``ops/*.py``); the
        serving path should reach none of them."""
        from pytorch_distributed_tpu_torch.ops import flash_attention as fa
        from pytorch_distributed_tpu_torch.ops import fused_conv_bn as fcb
        return {f.__name__: int(f.launches) for f in (
            fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
            fcb.fused_dgrad_wgrad, fcb.fused_dgrad_wgrad_3x3)}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


class ReplicaServer:
    """HTTP surface for one replica backend (see module docstring)."""

    def __init__(self, backend, *, replica_id: int = 0, port: int = 0,
                 host: str = "127.0.0.1", hb_dir: Optional[str] = None,
                 hb_interval_s: float = 1.0, epoch: int = 0,
                 world: Optional[int] = None, max_cache: int = 65536):
        self.backend = backend
        self.replica_id = int(replica_id)
        self.port = int(port)
        self.host = host
        self.draining = False
        self.drained = False
        self.inflight = 0
        self.cache_hits = 0
        self._cache: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self.max_cache = int(max_cache)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._hb = None
        if hb_dir:
            self._hb = heartbeat.HeartbeatWriter(
                hb_dir, process_index=self.replica_id, interval_s=0.0,
                world=world, epoch=epoch)
        self._hb_interval_s = float(hb_interval_s)

    # -- request handling -------------------------------------------------

    def handle_generate(self, payload: dict):
        try:
            rid = int(payload["rid"])
            prompt = [int(t) for t in payload.get("prompt", [])]
            n = int(payload.get("max_new_tokens", 8))
        except (KeyError, TypeError, ValueError):
            return 400, {"ok": False, "error": "bad request"}
        with self._lock:
            cached = self._cache.get(rid)
            if cached is not None:
                # idempotent replay: the original result, bit-for-bit.
                self.cache_hits += 1
                out = dict(cached)
                out["cached"] = True
                return 200, out
            if self.draining:
                return 200, {"ok": False, "rid": rid, "error": "draining",
                             "draining": True}
            self.inflight += 1
        try:
            ctx = None
            if payload.get("ctx"):
                try:
                    ctx = reqtrace.TraceContext.from_wire(
                        payload["ctx"])
                except (KeyError, TypeError, ValueError):
                    ctx = None
            if ctx is not None:
                ctx.hops.append(f"replica{self.replica_id}:recv")
            res = self.backend.generate(rid, prompt, n, ctx=ctx)
            if res.get("ok"):
                res["replica"] = self.replica_id
                res["cached"] = False
                if ctx is not None:
                    res["ctx"] = ctx.to_wire()
                with self._lock:
                    self._cache[rid] = res
                    while len(self._cache) > self.max_cache:
                        self._cache.popitem(last=False)
            return 200, res
        finally:
            with self._lock:
                self.inflight -= 1
                if self.draining and self.inflight == 0:
                    self.drained = True

    def handle_drain(self, wait: bool = False, timeout_s: float = 30.0):
        with self._lock:
            self.draining = True
            if self.inflight == 0:
                self.drained = True
        if wait:
            t_end = time.monotonic() + timeout_s
            while not self.drained and time.monotonic() < t_end:
                time.sleep(0.01)
        return {"ok": True, "draining": True, "drained": self.drained,
                "inflight": self.inflight, "replica": self.replica_id}

    def healthz(self) -> dict:
        return {"ok": True, "replica": self.replica_id,
                "draining": self.draining, "drained": self.drained,
                "inflight": self.inflight,
                "completed": getattr(self.backend, "completed", 0)}

    def stats(self) -> dict:
        return {"replica": self.replica_id, "inflight": self.inflight,
                "draining": self.draining,
                "computed": getattr(self.backend, "completed", 0),
                "cancelled": getattr(self.backend, "cancelled", 0),
                "cache_hits": self.cache_hits,
                "cache_size": len(self._cache),
                "kernel_launches": (self.backend.kernel_launches()
                                    if hasattr(self.backend, "kernel_launches")
                                    else None)}

    def render_metrics(self) -> str:
        line = export._line
        rec = self.backend.stats_record()
        lbl = {"rank": str(self.replica_id)}
        out = [line("ptd_up", lbl, 1.0),
               line("ptd_serving_queue_depth", lbl, rec["queue_depth"]),
               line("ptd_serving_active_seqs", lbl, rec["active_seqs"]),
               line("ptd_serving_kv_occupancy_pct", lbl,
                    rec["kv_occupancy_pct"]),
               line("ptd_serving_requests_completed_total", lbl,
                    rec["requests_completed"]),
               line("ptd_serving_tokens_per_second", lbl,
                    rec["tokens_per_s"])]
        for q in ("p50", "p95", "p99"):
            out.append(line("ptd_serving_ttft_ms",
                            {**lbl, "quantile": q}, rec[f"ttft_{q}_ms"]))
        return "\n".join(out) + "\n"

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        server = self

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
                    self._send(200, json.dumps(server.healthz()))
                elif self.path.startswith("/metrics"):
                    self._send(200, server.render_metrics(),
                               "text/plain; version=0.0.4")
                elif self.path.startswith("/stats"):
                    self._send(200, json.dumps(server.stats()))
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
                    code, body = server.handle_generate(payload)
                    self._send(code, json.dumps(body))
                elif self.path.startswith("/drain"):
                    self._send(200, json.dumps(server.handle_drain(
                        wait=bool(payload.get("wait")))))
                elif self.path.startswith("/cancel"):
                    ok = server.backend.cancel(payload.get("rid", -1))
                    self._send(200, json.dumps(
                        {"ok": True, "cancelled": bool(ok)}))
                else:
                    self._send(404, json.dumps({"ok": False}))

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        if self._hb is not None:
            threading.Thread(target=self._beat_loop, daemon=True).start()

    def _beat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._hb.beat(getattr(self.backend, "completed", 0),
                              force=True)
            except OSError:
                pass
            self._stop.wait(self._hb_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self.backend.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
