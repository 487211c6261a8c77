"""Where the paged serving engine's time goes on the card.

    python -m pytorch_distributed_tpu_torch.tools.profile_serving [--out DIR]

Builds the engine that chip_smoke.py phase 12 drives (the 183.9M LM in f32,
seeded random weights, 16 slots, 16-token blocks, a 1024-token window, 385
blocks), fills every slot with a seeded 512-token prompt, and traces with
``torch.profiler``:

1. 8 engine iterations with all 16 slots decoding (graph replays);
2. the same decode step run eagerly 8 times, outside the graph;
3. one 128-token prefill chunk, eagerly.

For each it prints the wall time, the device's busy time (the sum of its
kernels' time) and share of the wall, and device time by kernel, and writes
a Chrome trace under ``--out``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
from pytorch_distributed_tpu_torch.serving.scheduler import Request
from pytorch_distributed_tpu_torch.utils.device import resolve_device

LM = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12)


def _report(name, prof, wall_ms, out):
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {name}: wall {wall_ms} ms, device busy {busy_ms} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    if not kernels:
        print("[profile] device time: not measured (no device events recorded)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:14]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d} x  {e.key[:100]}")
    prof.export_chrome_trace(os.path.join(out, f"{name.split()[0]}.json"))


def _traced(name, fn, out):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report(name, prof, wall_ms, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/profile_serving")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[profile] card {card}")
    os.makedirs(args.out, exist_ok=True)
    eng = ServingEngine(init_lm_params(**LM, seed=0, device=dev), **LM, max_batch=16,
                        kv_blocks=385, block_size=16, blocks_per_seq=64, chunk_size=128,
                        max_new_tokens=384, device=dev)
    rng = torch.Generator().manual_seed(1)
    for rid in range(16):
        prompt = torch.randint(0, LM["vocab_size"], (512,), generator=rng).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=64))
    for _ in range(3):          # admit and prefill all 16, then warm decode
        eng.step()

    def engine_steps():
        for _ in range(8):
            eng.step()

    def eager_steps():
        for _ in range(8):
            eng._decode_step()

    chunk = torch.randint(0, LM["vocab_size"], (1, 128), device=dev)
    table = torch.zeros(1, 64, dtype=torch.int64, device=dev)   # the null block only
    pos = torch.arange(128, device=dev)[None]

    def prefill_chunk():
        with torch.no_grad():
            eng.model(chunk, eng.pk, eng.pv, table, pos)

    _traced("engine 8 iterations, 16 slots decoding (graph replays)", engine_steps, args.out)
    _traced("eager 8 decode steps outside the graph", eager_steps, args.out)
    _traced("prefill one 128-token chunk", prefill_chunk, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
