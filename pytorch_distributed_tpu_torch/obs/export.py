"""Per-rank live metric export: Prometheus text exposition over HTTP, a
copy of ``pytorch_distributed_tpu/obs/export.py`` (the same metric names and
labels, so the JAX package's ``scripts/obs_live.py`` and the port's
``tools/obs_live.py`` scrape either's ranks).

One daemon thread per rank serves the **latest already-buffered**
``MetricsLogger`` record plus heartbeat-class scalars on
``--metrics-port`` (rank *k* binds ``port + k``).  The training loop never
does exporter work: the exporter is a flush-time sink (``exporter.update``
sees each drained record, a dict of host floats), and all rendering, socket
I/O and the process-memory sample happen on the scrape path inside the
HTTP thread.  A port that cannot be bound raises at ``start``.

Endpoints:

- ``GET /metrics``  Prometheus text exposition (``ptd_`` prefix, every
  gauge labelled with ``rank``);
- ``GET /healthz``  ``ok`` + last-record age, 200/503.

The module needs only the standard library; ``tools/obs_live.py`` and the
tests parse the same exposition via ``parse_prometheus``, on a host with no
card.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from pytorch_distributed_tpu_torch.obs.heartbeat import sample_process_memory

# record fields promoted to dedicated gauges; everything else numeric is
# exported generically as ptd_metric{field="..."}
_STAT_FIELDS = {
    "step_time": "last",
    "step_time_ema": "ema",
    "step_time_p50": "p50",
    "step_time_p95": "p95",
    "step_time_max": "max",
}
# serving SLO fields (serving/engine.py) promoted to ptd_serving_*
# gauges so dashboards get stable names instead of ptd_metric{field=...}
_SERVING_FIELDS = {
    "ttft_p50_ms": ("ptd_serving_ttft_ms", {"quantile": "p50"}),
    "ttft_p95_ms": ("ptd_serving_ttft_ms", {"quantile": "p95"}),
    "ttft_p99_ms": ("ptd_serving_ttft_ms", {"quantile": "p99"}),
    "itl_p50_ms": ("ptd_serving_itl_ms", {"quantile": "p50"}),
    "itl_p95_ms": ("ptd_serving_itl_ms", {"quantile": "p95"}),
    "itl_p99_ms": ("ptd_serving_itl_ms", {"quantile": "p99"}),
    "queue_depth": ("ptd_serving_queue_depth", {}),
    "active_seqs": ("ptd_serving_active_seqs", {}),
    "kv_occupancy_pct": ("ptd_serving_kv_occupancy_pct", {}),
    "kv_frag_pct": ("ptd_serving_kv_frag_pct", {}),
    "preemptions": ("ptd_serving_preemptions_total", {}),
    "requests_completed": ("ptd_serving_requests_completed_total", {}),
    "tokens_per_s": ("ptd_serving_tokens_per_second", {}),
    # request-trace attribution gauges (obs/reqtrace.py step_fields):
    # the *why* behind a ptd_serving_ttft_ms breach — queue backlog vs
    # preemption-recompute thrash — live on /metrics.
    "queue_wait_share_p50": ("ptd_serving_attr_queue_wait_share_pct",
                             {"quantile": "p50"}),
    "queue_wait_share_p99": ("ptd_serving_attr_queue_wait_share_pct",
                             {"quantile": "p99"}),
    "preempt_redo_ms_p50": ("ptd_serving_attr_preempt_redo_ms",
                            {"quantile": "p50"}),
    "preempt_redo_ms_p99": ("ptd_serving_attr_preempt_redo_ms",
                            {"quantile": "p99"}),
    "trace_completed": ("ptd_serving_attr_traces_total", {}),
    "trace_spans_dropped": ("ptd_serving_attr_spans_dropped_total", {}),
}
# training step-time attribution gauges (obs/stepattr.py, --step-attr):
# the exact "where did my step go" split on /metrics, one gauge family
# labelled by component so dashboards can stack them, plus the
# data-wait share the alert rule watches.
_ATTR_FIELDS = {
    "attr_compute_ms": ("ptd_attr_ms", {"component": "compute"}),
    "attr_exposed_comm_ms": ("ptd_attr_ms", {"component": "exposed_comm"}),
    "attr_host_sync_ms": ("ptd_attr_ms", {"component": "host_sync"}),
    "attr_data_wait_ms": ("ptd_attr_ms", {"component": "data_wait"}),
    "attr_other_ms": ("ptd_attr_ms", {"component": "other"}),
    "attr_device_ms": ("ptd_attr_device_ms", {}),
    "attr_comm_ms": ("ptd_attr_comm_ms", {}),
    "attr_recon_err_ms": ("ptd_attr_recon_err_ms", {}),
    "data_wait_share": ("ptd_attr_data_wait_share_pct", {}),
}
_SKIP_FIELDS = ({"step", "t", "process", "epoch"} | set(_STAT_FIELDS)
                | set(_SERVING_FIELDS) | set(_ATTR_FIELDS))

# fleet-router gauge names (the JAX serving/router.py render_fleet_metrics /
# the obs_live fleet block).  The router renders these itself —
# this tuple pins the contract so scrapers and the exposition can't
# drift apart silently (asserted in the export selftest family).
FLEET_GAUGES = (
    "ptd_fleet_up",
    "ptd_fleet_inflight",
    "ptd_fleet_requests_total",
    "ptd_fleet_completed_total",
    "ptd_fleet_failed_total",
    "ptd_fleet_retries_total",
    "ptd_fleet_hedges_total",
    "ptd_fleet_hedges_won_total",
    "ptd_fleet_hedges_lost_total",
    "ptd_fleet_duplicates_suppressed_total",
    "ptd_fleet_replica_down_total",
    "ptd_fleet_last_scale",
    "ptd_fleet_replicas",
    "ptd_fleet_quarantined",
    "ptd_fleet_replica_state",
    "ptd_fleet_replica_queue_depth",
    "ptd_fleet_replica_kv_occupancy_pct",
    "ptd_fleet_replica_ttft_p99_ms",
    "ptd_fleet_replica_beat_age_seconds",
    "ptd_fleet_replica_dispatched_total",
    "ptd_fleet_replica_completed_total",
)


def _esc(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _line(name: str, labels: Dict[str, Any], value: float) -> str:
    lab = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{lab}}} {float(value):g}"


class MetricsExporter:
    """Serve the latest drained metrics record on an HTTP port.

    Registered with ``MetricsLogger`` twice: once as an owned sink
    (``start``/``stop`` → the logger starts it at ``register`` and stops
    it at ``close``) and once via ``exporter.update`` as a per-record
    step sink.  ``update`` only swaps a reference and bumps counters;
    rendering happens at scrape time.
    """

    def __init__(self, port: int, host: str = "127.0.0.1", rank: int = 0,
                 engine: Optional[Any] = None):
        self.port = int(port)  # 0 → ephemeral; re-read after start()
        self.host = host
        self.rank = int(rank)
        self.engine = engine  # optional AlertEngine: exposes firing gauges
        self.running = False
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._record: Optional[dict] = None
        self._record_at: float = 0.0
        self._events: Dict[str, int] = {}
        self._last_event: Optional[dict] = None
        self._started_at: float = 0.0

    # ------------------------------------------------------------ sink side
    def update(self, record: dict) -> None:
        """Flush-time step sink: remember the latest step record, count
        ft_events by kind.  No I/O, no rendering."""
        with self._lock:
            if "ft_event" in record:
                kind = str(record["ft_event"])
                self._events[kind] = self._events.get(kind, 0) + 1
                self._last_event = record
            elif "step_time" in record:
                self._record = record
                self._record_at = time.time()

    # --------------------------------------------------------- server side
    def start(self) -> None:
        if self.running:
            return
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 - silence per-request logs
                pass

            def do_GET(self):  # noqa: N802
                if self.path.split("?")[0] == "/metrics":
                    body = exporter.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path.split("?")[0] == "/healthz":
                    age = exporter.record_age()
                    ok = age is not None
                    body = json.dumps(
                        {"ok": ok, "rank": exporter.rank,
                         "record_age_s": age}).encode()
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"ptd-metrics-exporter-r{self.rank}", daemon=True)
        self._thread.start()
        self._started_at = time.time()
        self.running = True

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def record_age(self) -> Optional[float]:
        with self._lock:
            if self._record is None:
                return None
            return max(0.0, time.time() - self._record_at)

    # ---------------------------------------------------------- exposition
    def render(self) -> str:
        """Prometheus text exposition of the latest record + counters.
        Runs on the scrape thread only."""
        with self._lock:
            rec = dict(self._record) if self._record else None
            rec_at = self._record_at
            events = dict(self._events)
        rank = {"rank": self.rank}
        now = time.time()
        lines = [
            "# TYPE ptd_up gauge",
            _line("ptd_up", rank, 1.0),
            _line("ptd_uptime_seconds", rank,
                  max(0.0, now - self._started_at)),
        ]
        try:
            mem = sample_process_memory()
            if mem is not None:
                lines.append(_line("ptd_mem_rss_bytes", rank, float(mem)))
        except Exception:
            pass
        if rec is not None:
            lines.append("# TYPE ptd_step gauge")
            lines.append(_line("ptd_step", rank,
                               float(rec.get("step", -1))))
            lines.append(_line("ptd_record_age_seconds", rank,
                               max(0.0, now - rec_at)))
            lines.append("# TYPE ptd_step_time_seconds gauge")
            for field, stat in _STAT_FIELDS.items():
                v = rec.get(field)
                if isinstance(v, (int, float)):
                    lines.append(_line("ptd_step_time_seconds",
                                       dict(rank, stat=stat), float(v)))
            for field, (name, extra_labels) in sorted(
                    list(_SERVING_FIELDS.items())
                    + list(_ATTR_FIELDS.items())):
                v = rec.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lines.append(_line(name, dict(rank, **extra_labels),
                                       float(v)))
            for field in sorted(rec):
                if field in _SKIP_FIELDS:
                    continue
                v = rec[field]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                lines.append(_line("ptd_metric", dict(rank, field=field),
                                   float(v)))
        if events:
            lines.append("# TYPE ptd_ft_events_total counter")
            for kind in sorted(events):
                lines.append(_line("ptd_ft_events_total",
                                   dict(rank, kind=kind),
                                   float(events[kind])))
            lines.append(_line("ptd_alerts_total", rank,
                               float(events.get("alert", 0))))
        engine = self.engine
        if engine is not None:
            try:
                for alert in engine.active():
                    lines.append(_line(
                        "ptd_alert_firing",
                        dict(rank, rule=alert.name,
                             severity=alert.severity), 1.0))
            except Exception:
                pass
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------- scrape side

def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse text exposition back into ``(name, labels, value)`` samples.
    Handles exactly what ``render`` emits (and the common subset of the
    format) — shared by ``obs_live`` and the tests."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, _, val = line.rpartition(" ")
            labels: Dict[str, str] = {}
            if "{" in head:
                name, _, rest = head.partition("{")
                body = rest.rsplit("}", 1)[0]
                for part in _split_labels(body):
                    k, _, v = part.partition("=")
                    labels[k.strip()] = (
                        v.strip().strip('"')
                        .replace(r"\"", '"').replace(r"\n", "\n")
                        .replace(r"\\", "\\"))
            else:
                name = head
            out.append((name.strip(), labels, float(val)))
        except (ValueError, IndexError):
            continue
    return out


def _split_labels(body: str) -> List[str]:
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    parts, cur, quoted, escape = [], [], False, False
    for ch in body:
        if escape:
            cur.append(ch)
            escape = False
        elif ch == "\\":
            cur.append(ch)
            escape = True
        elif ch == '"':
            cur.append(ch)
            quoted = not quoted
        elif ch == "," and not quoted:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in (s.strip() for s in parts) if p]


def sample_value(samples: List[Tuple[str, Dict[str, str], float]],
                 name: str, **labels: str) -> Optional[float]:
    """First sample matching ``name`` whose labels include ``labels``."""
    for n, lab, v in samples:
        if n == name and all(lab.get(k) == str(w)
                             for k, w in labels.items()):
            return v
    return None


def scrape(url: str, timeout: float = 2.0
           ) -> List[Tuple[str, Dict[str, str], float]]:
    """GET one exporter endpoint and parse it (stdlib urllib)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_prometheus(resp.read().decode("utf-8", "replace"))
