"""Observability of the PyTorch port (mirrors pytorch_distributed_tpu/obs).

Ported (the metrics stream, ROADMAP.md item A12's first slice):

- ``metrics``   — ``MetricsLogger``: one structured JSONL record per step,
  with lazy device-scalar conversion and sink registration (the epoch
  CSV, the telemetry sampler, the goodput tracker), and ``read_metrics``.
- ``trace``     — ``scope()`` (``record_function``) and ``ProfileWindow`` /
  ``capture``: epoch/step-windowed ``torch.profiler`` Chrome traces.
- ``heartbeat`` — per-process beats to a shared directory and the
  straggler monitor (stdlib only).
- ``flops``     — the analytic FLOPs/bytes models, the card tables and
  ``MFUReporter``; ``counted_step_flops`` cross-checks the models.
- ``goodput``   — the goodput/badput ledger over the metrics JSONL.
- ``stepattr``  — ``StepAttr``: the per-step wall-time attribution.

The files, fields and names are the JAX package's, so its readers (and
``scripts/obs_report.py``) fold the port's runs.  Not ported yet:
``alerts``, ``export`` (``--metrics-port``), ``flightrec`` and
``--hang-timeout`` (A12's second slice, with ``scripts/obs_report.py``),
the serving engine's ``trace`` and ``watchdog`` hooks and ``reqtrace``
(its third), and ``comms``, ``memory``, ``timeline`` and ``watchdog``
(``--comm-ledger``, ``--mem-ledger``, ``--lowering-cache``,
``--watch-recompiles``), which read XLA programs and wait for their torch
meaning with A13.
"""

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
]
