"""Where the training path's time goes on the card.

    python -m pytorch_distributed_tpu_torch.tools.profile_train [--out DIR] [--steps N]

Builds the LM that chip_smoke.py trains (vocab 32000, d_model 1024, 16
heads, 12 layers, f32 weights, bf16 compute, seeded random weights) and its
SGD step, runs two warm-up steps on the synthetic token stream at sequence
length 4096 and batch 4, then traces ``--steps`` steps with
``torch.profiler``.  Prints the wall time per step, the device's busy time
(the sum of its kernels' time) and share of the wall, the flash kernels'
(K1, K2, K3) share of device time, device time by class (flash, cuBLAS
GEMMs, the rest) and by kernel; writes a
Chrome trace under ``--out``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.train.lm import SyntheticTokenDataset, make_lm_train_step
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.device import resolve_device

# Substrings of the flash kernels' names; training is bf16, so K2 and K3
# are their tensor-core instantiations.
FLASH_KERNELS = {"K1": "flash_fwd_kernel", "K2": "flash_bwd_dq_mma_kernel",
                 "K3": "flash_bwd_dkv_mma_kernel"}
# Substrings of cuBLAS's matrix-product kernel names on Hopper.
GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/profile_train")
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    B, L = 4, 4096
    model = TransformerLM(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12,
                          dtype=torch.bfloat16, param_dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    step = make_lm_train_step(model, sgd(model.parameters()))
    data = SyntheticTokenDataset(64, L, 32000)
    batches = [torch.from_numpy(data.batch(i, B)).to(dev) for i in range(args.steps + 2)]
    for tokens in batches[:2]:
        step(tokens, 1e-2)
    torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tokens in batches[2:]:
            step(tokens, 1e-2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    # User annotations (the optimizer's step range) also show on the device
    # timeline; they span kernels already counted, so they are left out.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    print(f"[profile] card {card}; train step B={B} L={L} over {args.steps} steps: "
          f"wall {wall_ms} ms/step, device busy {busy_ms} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    if not kernels:
        print("[profile] device time: not measured (no device events recorded)")
    flash_ms = 0.0
    for tag, name in FLASH_KERNELS.items():
        hits = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3 / args.steps
        n = sum(e.count for e in hits) / args.steps
        flash_ms += ms
        print(f"[profile] {tag} {name}: {ms} ms/step in {n} launches/step "
              f"({100 * ms / busy_ms if busy_ms else 0:.1f}% of device time)")
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if any(s in e.key.lower() for s in GEMM_NAMES)) / 1e3 / args.steps
    print(f"[profile] by class: flash {flash_ms} ms/step, cuBLAS GEMMs {gemm_ms} "
          f"ms/step, everything else (elementwise, reductions, copies, SGD) "
          f"{busy_ms - flash_ms - gemm_ms} ms/step")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:10.3f} ms/step "
              f"{e.count / args.steps:6.0f} x  {e.key[:100]}")
    prof.export_chrome_trace(os.path.join(args.out, "train_steps.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
