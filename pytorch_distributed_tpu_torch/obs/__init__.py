"""Observability of the PyTorch port (mirrors pytorch_distributed_tpu/obs).

Ported (ROADMAP.md item A12, slices 1 to 3):

- ``metrics``   — ``MetricsLogger``: one structured JSONL record per step,
  with lazy device-scalar conversion and sink registration (the epoch
  CSV, the telemetry sampler, the goodput tracker, the exporter and the
  alert engine), and ``read_metrics``.
- ``trace``     — ``scope()`` (``record_function``) and ``ProfileWindow`` /
  ``capture``: epoch/step-windowed ``torch.profiler`` Chrome traces.
- ``heartbeat`` — per-process beats to a shared directory and the
  straggler monitor (stdlib only).
- ``flops``     — the analytic FLOPs/bytes models, the card tables and
  ``MFUReporter``; ``counted_step_flops`` cross-checks the models.
- ``goodput``   — the goodput/badput ledger over the metrics JSONL.
- ``stepattr``  — ``StepAttr``: the per-step wall-time attribution.
- ``flightrec`` — the per-rank flight recorder, its signal dump and the
  hang watchdog (``--flight-rec``, ``--hang-timeout``); ``tools/postmortem.py``
  merges the dumps.
- ``timeline``  — the heartbeat clock alignment the postmortem uses.
- ``export``    — the per-rank Prometheus exporter (``--metrics-port``);
  ``tools/obs_live.py`` scrapes it.
- ``alerts``    — the declarative alert rules and engine (``--alerts``).
- ``reqtrace``  — the serving engine's per-request span recorder and its
  TTFT attribution (``serve_lm --req-trace``); ``tools/obs_trace.py``
  reads it.
- ``watchdog``  — the serving engine's recapture watchdog: a CUDA-graph
  capture is the port's compile event.

The files, fields and names are the JAX package's, so its readers (and
``scripts/obs_report.py``) fold the port's runs.  Not ported yet: the
``scripts/obs_report.py`` twin and ``timeline``'s request-trace merge, and
``comms``, ``memory`` and the rest of ``timeline`` (``--comm-ledger``,
``--mem-ledger``, ``--lowering-cache``, the XPlane parser), which read XLA
programs and wait for their torch meaning with A13; the trainers'
``--watch-recompiles`` exits (their steps run eagerly: nothing is captured).

The names below load their module on first use: ``metrics``, ``heartbeat``,
``export``, ``alerts`` and ``reqtrace`` import no torch, so the fleet's
processes (``serving/router.py``, ``tools/serve_fleet.py``,
``tools/obs_trace.py``) import them without loading torch.
"""

import importlib

_EXPORTS = {
    "MetricsLogger": "metrics", "read_metrics": "metrics",
    "HeartbeatWriter": "heartbeat", "read_heartbeats": "heartbeat",
    "find_stragglers": "heartbeat", "fleet_rollup": "heartbeat",
    "sample_process_memory": "heartbeat",
    "scope": "trace", "annotate": "trace", "capture": "trace",
    "parse_span": "trace", "ProfileWindow": "trace",
    "StepCost": "flops", "MFUReporter": "flops", "image_step_cost": "flops",
    "lm_step_cost": "flops", "lm_step_cost_for": "flops",
    "counted_step_flops": "flops", "device_peak_flops": "flops",
    "GoodputTracker": "goodput", "compute_goodput": "goodput",
    "summarize_goodput": "goodput",
    "StepAttr": "stepattr",
    "FlightRecorder": "flightrec", "FlightSignalDump": "flightrec",
    "HangWatchdog": "flightrec", "attach_to_metrics": "flightrec",
    "dump_path": "flightrec", "find_dumps": "flightrec",
    "read_heartbeat_steps": "timeline", "clock_offsets_from_heartbeats": "timeline",
    "MetricsExporter": "export", "parse_prometheus": "export",
    "sample_value": "export", "scrape": "export",
    "AlertEngine": "alerts", "AlertRuleError": "alerts", "Rule": "alerts",
    "load_rules": "alerts", "default_rules": "alerts", "evaluate_stream": "alerts",
    "alerts_data": "alerts", "dead_ranks_from_events": "alerts",
    "summarize_alerts": "alerts",
    "ReqTracer": "reqtrace", "TraceContext": "reqtrace",
    "RecompileWatchdog": "watchdog",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
