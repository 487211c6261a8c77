"""Per-epoch wall-clock CSV, a copy of ``pytorch_distributed_tpu/utils/csvlog.py``:
appends ``[timestamp, epoch_seconds]`` rows (with a header row first) to
``path`` when it is set, opening the file per write."""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

HEADER = ("timestamp", "epoch_seconds")


class EpochCSVLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._t0: Optional[float] = None

    def epoch_start(self) -> None:
        self._t0 = time.time()

    def epoch_end(self) -> float:
        if self._t0 is None:
            raise RuntimeError("EpochCSVLogger.epoch_end() called without a matching "
                               "epoch_start()")
        elapsed = time.time() - self._t0
        if self.path:
            write_header = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
            with open(self.path, "a+", newline="") as f:
                w = csv.writer(f)
                if write_header:
                    w.writerow(HEADER)
                w.writerow([time.time(), elapsed])
        self._t0 = None
        return elapsed
