"""Running-average meters and the progress row printer, the port of
``pytorch_distributed_tpu/train/meters.py`` (the reference's
``AverageMeter`` / ``ProgressMeter``).

``update()`` accepts device scalars lazily: values are converted to Python
floats only at display or read time, so the step loop does not wait for the
device on every step.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Sequence, Tuple


class AverageMeter:
    """Tracks current value, running sum/count, and average."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self._pending: List[tuple] = []  # (value, n) possibly still on device
        self._sum = 0.0
        self._count = 0
        self._val = 0.0

    def update(self, val, n: int = 1) -> None:
        """Record a value; ``val`` may be a device scalar not computed yet."""
        self._pending.append((val, n))

    def _drain(self) -> None:
        for val, n in self._pending:
            v = float(val)  # waits for a device value
            self._val = v
            self._sum += v * n
            self._count += n
        self._pending.clear()

    @property
    def val(self) -> float:
        self._drain()
        return self._val

    @property
    def avg(self) -> float:
        self._drain()
        return self._sum / self._count if self._count else 0.0

    @property
    def sum(self) -> float:
        self._drain()
        return self._sum

    @property
    def count(self) -> int:
        self._drain()
        return self._count

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """Prints ``<prefix>[ i/N]\\t<meter>\\t<meter>…`` rows."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter], prefix: str = ""):
        self.batch_fmtstr = self._batch_fmtstr(num_batches)
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line, flush=True)
        return line

    @staticmethod
    def _batch_fmtstr(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


class StepMeters:
    """The step loop's instrumentation: a batch-time meter, named metric
    meters fed from the step's metrics dict, and the progress row.

    ``fields`` is an ordered sequence of ``(metrics_key, display_name,
    fmt)`` triples; ``update`` takes the (possibly not yet computed) metrics
    dict and returns the host-measured seconds since the previous update.
    """

    def __init__(self, num_batches: int,
                 fields: Sequence[Tuple[str, str, str]], prefix: str = ""):
        self.batch_time = AverageMeter("Time", ":6.3f")
        self._keys = [k for k, _, _ in fields]
        self.meters = {k: AverageMeter(name, fmt) for k, name, fmt in fields}
        self.progress = ProgressMeter(
            num_batches, [self.batch_time, *self.meters.values()], prefix
        )
        self._end = time.time()

    def __getitem__(self, key: str) -> AverageMeter:
        return self.meters[key]

    def update(self, metrics, n: int = 1) -> float:
        """Record one step; values stay lazy (drained at display/read time)."""
        for k in self._keys:
            self.meters[k].update(metrics[k], n)
        now = time.time()
        dt = now - self._end
        self.batch_time.update(dt)
        self._end = now
        return dt

    def restart_clock(self) -> None:
        """Exclude out-of-band work (eval, checkpoint) from the step timer."""
        self._end = time.time()

    def maybe_display(self, batch: int, print_freq: int) -> None:
        if print_freq > 0 and batch % print_freq == 0:
            self.progress.display(batch)
