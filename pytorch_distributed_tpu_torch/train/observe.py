"""The observability of one training run, as both JAX trainers wire it
(``pytorch_distributed_tpu/train/trainer.py`` and ``train/lm.py``): one
``MetricsLogger`` hub (``--metrics-jsonl``), this process's
``HeartbeatWriter`` (``--hb-dir``), the ``MFUReporter`` (``--mfu``), the
``GoodputTracker`` (``--goodput``), the ``StepAttr`` windows
(``--step-attr``) and the one-off ``stepattr_phases`` event; the death
paths: the ``FlightRecorder`` (``--flight-rec``) with every ft_event
mirrored into its ring, its signal dump and the ``HangWatchdog``
(``--hang-timeout``); and the live plane: the ``MetricsExporter``
(``--metrics-port``, rank k serving port + k) registered on the hub for
its lifecycle and as the per-record sink, and the ``AlertEngine``
(``--alerts``), a sink of the hub whose firings are booked as ``alert``
ft_events.  The image ``Trainer`` and the ``LMTrainer`` each hold one
``TrainObs``; with every flag off it is a hub that writes nothing and adds
no work to a step.

The device window of ``--step-attr`` ends in ``torch.cuda.synchronize()``
on a card, so the step's device time lands in its own window.  The hang
watchdog times the host's step window (``step_begin`` .. ``step_end``)
and adds no synchronize: a collective that blocks the host (gloo) stalls
inside the window; one the card runs (NCCL) shows in the step where the
host next waits.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ft.integrity import CheckpointCorruptError
from pytorch_distributed_tpu_torch.obs import flops, stepattr
from pytorch_distributed_tpu_torch.obs.alerts import AlertEngine, default_rules, load_rules
from pytorch_distributed_tpu_torch.obs.export import MetricsExporter
from pytorch_distributed_tpu_torch.obs.flightrec import (
    FlightRecorder,
    FlightSignalDump,
    HangWatchdog,
    attach_to_metrics,
)
from pytorch_distributed_tpu_torch.obs.goodput import GoodputTracker
from pytorch_distributed_tpu_torch.obs.heartbeat import HeartbeatWriter, sample_process_memory
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_tpu_torch.obs.stepattr import StepAttr


class TrainObs:
    """``cost`` builds the run's analytic ``StepCost`` (for ``--mfu`` and
    the phase roofline); ``n_devices`` is the number of ranks the step
    spans and ``device`` this process's; ``hb_world`` the data-parallel
    world the heartbeats and the flight ring record as membership."""

    def __init__(self, device: torch.device, process_index: int = 0, n_devices: int = 1,
                 metrics_jsonl: Optional[str] = None, hb_dir: Optional[str] = None,
                 hb_interval_s: float = 5.0, hb_world: Optional[int] = None,
                 mfu: bool = False, goodput: bool = False, step_attr: bool = False,
                 cost: Optional[Callable[[], flops.StepCost]] = None,
                 flight_rec: Optional[str] = None, hang_timeout: float = 30.0,
                 metrics_port: int = 0, alerts: Optional[str] = None):
        self.device = device
        self.primary = process_index == 0
        self.n_devices = n_devices
        self.kind = flops.device_kind(device)
        self._cost = cost
        self.obs = MetricsLogger(metrics_jsonl, process_index=process_index)
        self.hb = (HeartbeatWriter(hb_dir, process_index, interval_s=hb_interval_s,
                                   world=hb_world) if hb_dir else None)
        self.mfu = (flops.MFUReporter(cost(), n_devices=n_devices,
                                      peak_per_chip=flops.device_peak_flops(device))
                    if mfu else None)
        self.goodput = self.obs.register(GoodputTracker()) if goodput else None
        self.stepattr = (StepAttr(link_bytes_per_s=flops.chip_link_bytes(self.kind))
                         if step_attr else None)
        self._phases_booked = False
        # Crash forensics: the ring takes every ft_event the hub logs; the
        # signal dump and the watchdog thread start in ``arm``.
        self.flight = self.hang_wd = self._flight_sig = None
        if flight_rec:
            self.flight = FlightRecorder(flight_rec, rank=process_index)
            self.hang_wd = HangWatchdog(self.flight, obs=self.obs, timeout=float(hang_timeout))
            attach_to_metrics(self.flight, self.obs)
            self.flight.set_membership(hb_world if hb_world is not None else n_devices, 0)
        # The live plane: two flush-time sinks of the hub, nothing added to
        # the step.  The exporter is an owned sink (started here, so a port
        # that cannot be bound raises now; stopped at ``close``).
        self.exporter = None
        if int(metrics_port or 0) > 0:
            self.exporter = MetricsExporter(int(metrics_port) + process_index,
                                            rank=process_index)
            self.obs.register(self.exporter)          # lifecycle (start/stop)
            self.obs.register(self.exporter.update)   # per-record sink
        self.alerts = None
        if alerts:
            rules = default_rules() if alerts == "default" else load_rules(alerts)
            self.alerts = AlertEngine(rules, emit=self._emit_alert,
                                      process_index=process_index)
            self.obs.register(self.alerts)
            if self.exporter is not None:
                self.exporter.engine = self.alerts    # ptd_alert_firing

    def _emit_alert(self, **fields) -> None:
        """The engine's emit hook: a firing is booked as an ``alert``
        ft_event in the same stream (and so in the flight ring)."""
        self.obs.log_event("alert", **fields)

    # -- the death paths (no-ops without --flight-rec) -------------------
    def arm(self, signals: Tuple[int, ...] = (signal.SIGTERM,)) -> None:
        """The start of ``fit``: the flight recorder's signal dump (main
        thread only, installed after the preemption guard, so it dumps and
        then chains to the guard) and the hang watchdog; an exporter that a
        previous ``fit``'s ``close`` stopped serves again."""
        if self.exporter is not None and not self.exporter.running:
            self.obs.register(self.exporter)
        if self.flight is None:
            return
        if threading.current_thread() is threading.main_thread():
            self._flight_sig = FlightSignalDump(self.flight, signals=signals).install()
        self.hang_wd.start()

    def disarm(self) -> None:
        if self.hang_wd is not None:
            self.hang_wd.stop()
        if self._flight_sig is not None:
            self._flight_sig.uninstall()
            self._flight_sig = None

    def step_begin(self, step: int) -> None:
        """The step window and its collective region open (two deque
        appends; no comm ledger, so no collective kind or bytes)."""
        if self.flight is not None:
            self.flight.step_begin(step)
            self.flight.coll_enter(step)

    def step_end(self, step: int) -> None:
        if self.flight is not None:
            self.flight.coll_exit(step)
            self.flight.step_end(step)

    def checkpoint(self, step: int, **fields) -> None:
        """A checkpoint save, booked in the ring."""
        if self.flight is not None:
            self.flight.event("checkpoint", step, **fields)

    def dump_exception(self, exc: BaseException, step: int) -> None:
        """The exception death path: the ring dumped with the exception's
        type (``checkpoint_corrupt`` for a corrupt checkpoint); the caller
        re-raises."""
        if self.flight is None:
            return
        self.flight.record("exception", step, error=type(exc).__name__)
        self.flight.dump("checkpoint_corrupt" if isinstance(exc, CheckpointCorruptError)
                         else f"exception:{type(exc).__name__}")

    # -- the three windows (no-ops without --step-attr) ------------------
    def data_wait(self):
        return self.stepattr.data_wait() if self.stepattr else contextlib.nullcontext()

    @contextlib.contextmanager
    def device_window(self):
        if self.stepattr is None:
            yield
            return
        with self.stepattr.device():
            yield
            if self.device.type == "cuda":
                # The step's blocking wait (the JAX block_until_ready).
                torch.cuda.synchronize(self.device)

    def host_sync(self):
        return self.stepattr.host_sync() if self.stepattr else contextlib.nullcontext()

    # -- per step --------------------------------------------------------
    def log_step(self, step: int, step_time: float, n_items: float, lr, scalars: dict,
                 extra: Optional[dict] = None) -> None:
        """The step's record (MFU and attribution fields added), the phase
        event after the first one, and a heartbeat."""
        extra = dict(extra or {})
        if self.mfu is not None:
            extra.update(self.mfu.fields(step_time))
        sa = self.stepattr
        if sa is not None:
            extra.update(sa.fields(step_time))
        # The lazy-flush scalar drain accrues to the next step's host_sync
        # window (its step time covers this wall time).
        with self.host_sync():
            self.obs.log_step(step, step_time=step_time, n_items=n_items, lr=lr,
                              scalars=scalars, extra=extra or None)
        # Booked after the first step's record, so its timestamp cannot
        # widen the goodput wall span back across the first step.
        if sa is not None and not self._phases_booked:
            self._book_phases()
        self.beat(step)

    def _book_phases(self) -> None:
        """The static per-phase roofline ledger, once, as a
        ``stepattr_phases`` ft_event (the JAX trainers' ``_book_stepattr_phases``;
        the port has no comm ledger, so no wire bytes)."""
        self._phases_booked = True
        try:
            cost = self._cost()
        except (AttributeError, KeyError, ValueError):
            return  # no analytic model: attribution still runs, no roofline
        prof = stepattr.phase_profile(
            cost.breakdown, stepattr.split_step_bytes(cost.bytes, cost.params),
            comm_bytes=0.0, peak_flops=flops.chip_peak_flops(self.kind),
            hbm_bw=flops.chip_hbm_bw(self.kind), link_bw=flops.chip_link_bytes(self.kind),
            n_devices=self.n_devices)
        self.obs.log_event("stepattr_phases", **stepattr.phase_event_fields(prof))

    def beat(self, step: int, force: bool = False) -> None:
        if self.hb is not None:
            self.hb.beat(step, force=force, step_time_ema=self.obs.ema,
                         last_ft=self.obs.last_event_kind, mem_bytes=sample_process_memory(),
                         data_wait_ms=(self.stepattr.data_wait_ema_ms
                                       if self.stepattr is not None else None))
            if self.flight is not None and not force:
                self.flight.heartbeat({"step": step, "last_ft": self.obs.last_event_kind})

    def close(self, last_step: int) -> None:
        """End of ``fit``: the watchdog and the signal dump taken down, the
        last beat, the records flushed, the goodput summary (printed by
        process 0), the registered sinks (the exporter too) stopped."""
        self.disarm()
        if self.hb is not None:
            self.beat(max(0, last_step), force=True)
        self.obs.flush()
        if self.goodput is not None and self.primary:
            print(f"=> {self.goodput.format_summary()}", flush=True)
        self.obs.close()
