"""Device telemetry sampler — the reference's ``statistics.sh`` twin, the
port of ``pytorch_distributed_tpu/utils/telemetry.py``.

The reference samples ``nvidia-smi --query-gpu=timestamp,index,memory.total,
memory.used,utilization.gpu`` every 500 ms into a per-recipe CSV.  Here the
JAX package's file contract, ``timestamp,index,bytes_limit,bytes_in_use,
peak_bytes`` (no header row), is fed on a card from
``torch.cuda.memory_stats(i)``: ``bytes_in_use`` is the caching allocator's
``allocated_bytes.all.current`` (live tensors of this process),
``peak_bytes`` its ``allocated_bytes.all.peak``, and ``bytes_limit`` the
card's ``total_memory``.

On ``device="cpu"`` there is no allocator statistic, so, as the JAX rule
for a runtime without ``memory_stats`` has it, ``bytes_limit`` is 0;
``bytes_in_use`` is then this process's resident set size (``VmRSS``) and
``peak_bytes`` its high-water mark (``VmHWM``), both from
``/proc/self/status``: the whole process's memory, not tensor bytes.

Run standalone (``python -m pytorch_distributed_tpu_torch.utils.telemetry
[out.csv] [interval] [--device cpu]``, the root ``tpu_statistics.py``'s
twin) or in-process via ``TelemetrySampler``.  Both take the card unless
the caller asks for the CPU, and raise without one.
"""

from __future__ import annotations

import csv
import sys
import threading
import time
from typing import List, Optional

import torch

from pytorch_distributed_tpu_torch.utils.device import resolve_device


def _proc_status_bytes(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    return 0


def sample_devices(device="cuda") -> List[list]:
    """One CSV row for ``device`` (a card, by default the current one; or
    the CPU): ``[timestamp, index, bytes_limit, bytes_in_use, peak_bytes]``."""
    dev = resolve_device(device)
    now = time.time()
    if dev.type != "cuda":
        return [[now, 0, 0, _proc_status_bytes("VmRSS"), _proc_status_bytes("VmHWM")]]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    limit = torch.cuda.get_device_properties(index).total_memory
    return [[now, index, limit, stats.get("allocated_bytes.all.current", 0),
             stats.get("allocated_bytes.all.peak", 0)]]


class TelemetrySampler:
    """Background sampler appending CSV rows every ``interval_s`` seconds
    (the statistics.sh contract) until ``stop``; it samples once more at
    ``stop``, so a short run still leaves its last reading."""

    def __init__(self, path: str, interval_s: float = 0.5, device="cuda"):
        self.path = path
        self.interval_s = interval_s
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _write(self) -> None:
        with open(self.path, "a+", newline="") as f:
            csv.writer(f).writerows(sample_devices(self.device))

    def start(self) -> "TelemetrySampler":
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._write()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join()
            self._thread = None
            self._write()


def main(argv=None) -> None:
    """``[outfile.csv] [interval_seconds] [--device cpu]``: sample until
    Ctrl-C."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    path = args[0] if args else "tpu_statistics.csv"
    interval = float(args[1]) if len(args) > 1 else 0.5
    sampler = TelemetrySampler(path, interval, device=device).start()
    print(f"sampling device memory to {path} every {interval}s (Ctrl-C to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        sampler.stop()


if __name__ == "__main__":
    main()
