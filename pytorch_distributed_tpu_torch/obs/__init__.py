"""Observability of the PyTorch port (mirrors pytorch_distributed_tpu/obs).

Ported (ROADMAP.md item A12, slices 1 and 2):

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

The files, fields and names are the JAX package's, so its readers (and
``scripts/obs_report.py``) fold the port's runs.  Not ported yet: the
serving engine's ``trace`` and ``watchdog`` hooks, ``reqtrace`` and the
``scripts/obs_report.py`` twin (A12's third slice), and ``comms``,
``memory``, ``watchdog`` and the rest of ``timeline`` (``--comm-ledger``,
``--mem-ledger``, ``--lowering-cache``, ``--watch-recompiles``, the XPlane
parser), which read XLA programs and wait for their torch meaning with A13.
"""

from pytorch_distributed_tpu_torch.obs.alerts import (
    AlertEngine,
    AlertRuleError,
    Rule,
    alerts_data,
    dead_ranks_from_events,
    default_rules,
    evaluate_stream,
    load_rules,
    summarize_alerts,
)
from pytorch_distributed_tpu_torch.obs.export import (
    MetricsExporter,
    parse_prometheus,
    sample_value,
    scrape,
)
from pytorch_distributed_tpu_torch.obs.flightrec import (
    FlightRecorder,
    FlightSignalDump,
    HangWatchdog,
    attach_to_metrics,
    dump_path,
    find_dumps,
)
from pytorch_distributed_tpu_torch.obs.flops import (
    MFUReporter,
    StepCost,
    counted_step_flops,
    device_peak_flops,
    image_step_cost,
    lm_step_cost,
    lm_step_cost_for,
)
from pytorch_distributed_tpu_torch.obs.goodput import (
    GoodputTracker,
    compute_goodput,
    summarize_goodput,
)
from pytorch_distributed_tpu_torch.obs.heartbeat import (
    HeartbeatWriter,
    find_stragglers,
    fleet_rollup,
    read_heartbeats,
    sample_process_memory,
)
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger, read_metrics
from pytorch_distributed_tpu_torch.obs.stepattr import StepAttr
from pytorch_distributed_tpu_torch.obs.timeline import (
    clock_offsets_from_heartbeats,
    read_heartbeat_steps,
)
from pytorch_distributed_tpu_torch.obs.trace import (
    ProfileWindow,
    annotate,
    capture,
    parse_span,
    scope,
)

__all__ = [
    "MetricsLogger",
    "read_metrics",
    "HeartbeatWriter",
    "read_heartbeats",
    "find_stragglers",
    "fleet_rollup",
    "sample_process_memory",
    "scope",
    "annotate",
    "capture",
    "parse_span",
    "ProfileWindow",
    "StepCost",
    "MFUReporter",
    "image_step_cost",
    "lm_step_cost",
    "lm_step_cost_for",
    "counted_step_flops",
    "device_peak_flops",
    "GoodputTracker",
    "compute_goodput",
    "summarize_goodput",
    "StepAttr",
    "FlightRecorder",
    "FlightSignalDump",
    "HangWatchdog",
    "attach_to_metrics",
    "dump_path",
    "find_dumps",
    "read_heartbeat_steps",
    "clock_offsets_from_heartbeats",
    "MetricsExporter",
    "parse_prometheus",
    "sample_value",
    "scrape",
    "AlertEngine",
    "AlertRuleError",
    "Rule",
    "load_rules",
    "default_rules",
    "evaluate_stream",
    "alerts_data",
    "dead_ranks_from_events",
    "summarize_alerts",
]
