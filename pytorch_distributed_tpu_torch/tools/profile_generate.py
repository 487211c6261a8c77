"""Where the serving path's time goes on the card.

    python -m pytorch_distributed_tpu_torch.tools.profile_generate [--out DIR]

Builds the LM that chip_smoke.py drives (vocab 32000, d_model 1024, 16
heads, 12 layers, bf16, seeded random weights), warms it up, and traces two
``generate`` calls on 4 prompts of 4096 tokens with ``torch.profiler``: one
new token (the prefill) and 9 new tokens (the prefill and 8 decode steps).
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

from pytorch_distributed_tpu_torch.models.generate import generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out/profile_generate")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = TransformerLM(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12,
                          dtype=torch.bfloat16, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, 32000, (4, 4096), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    generate(model, prompt, 2)
    torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)

    for n_new in (1, 9):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(model, prompt, n_new)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[profile] card {card}; generate B=4 P=4096 n={n_new}: wall "
              f"{wall_ms} ms, device busy {busy_ms} ms "
              f"({100 * busy_ms / wall_ms:.1f}% of wall)")
        if not kernels:
            print("[profile] device time: not measured (no device events recorded)")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True)[:12]:
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d} x  {e.key[:100]}")
        prof.export_chrome_trace(os.path.join(args.out, f"generate_n{n_new}.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
