"""The metrics stream of one training run, as both JAX trainers wire it
(``pytorch_distributed_tpu/train/trainer.py`` and ``train/lm.py``): one
``MetricsLogger`` hub (``--metrics-jsonl``), this process's
``HeartbeatWriter`` (``--hb-dir``), the ``MFUReporter`` (``--mfu``), the
``GoodputTracker`` (``--goodput``), the ``StepAttr`` windows
(``--step-attr``) and the one-off ``stepattr_phases`` event.  The image
``Trainer`` and the ``LMTrainer`` each hold one ``TrainObs``; with every
flag off it is a hub that writes nothing and adds no work to a step.

The device window of ``--step-attr`` ends in ``torch.cuda.synchronize()``
on a card, so the step's device time lands in its own window.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from pytorch_distributed_tpu_torch.obs import flops, stepattr
from pytorch_distributed_tpu_torch.obs.goodput import GoodputTracker
from pytorch_distributed_tpu_torch.obs.heartbeat import HeartbeatWriter, sample_process_memory
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_tpu_torch.obs.stepattr import StepAttr


class TrainObs:
    """``cost`` builds the run's analytic ``StepCost`` (for ``--mfu`` and
    the phase roofline); ``n_devices`` is the number of ranks the step
    spans and ``device`` this process's."""

    def __init__(self, device: torch.device, process_index: int = 0, n_devices: int = 1,
                 metrics_jsonl: Optional[str] = None, hb_dir: Optional[str] = None,
                 hb_interval_s: float = 5.0, hb_world: Optional[int] = None,
                 mfu: bool = False, goodput: bool = False, step_attr: bool = False,
                 cost: Optional[Callable[[], flops.StepCost]] = None):
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

    def close(self, last_step: int) -> None:
        """End of ``fit``: the last beat, the records flushed, the goodput
        summary (printed by process 0), the registered sinks stopped."""
        if self.hb is not None:
            self.beat(max(0, last_step), force=True)
        self.obs.flush()
        if self.goodput is not None and self.primary:
            print(f"=> {self.goodput.format_summary()}", flush=True)
        self.obs.close()
