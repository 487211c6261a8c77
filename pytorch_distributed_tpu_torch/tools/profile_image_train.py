"""Where the image training path's time goes on the card.

    python -m pytorch_distributed_tpu_torch.tools.profile_image_train [--out DIR]
        [--steps N] [--batch B] [--unfused] [--precision bf16|fp32]

Builds the ResNet-50 that chip_smoke.py trains (f32 weights, bf16 compute,
seeded random weights, ``--fused-convbn`` unless ``--unfused``) and its SGD
step, makes the synthetic batches beforehand (the trainer's own dataset and
loader, copied to the card before timing), runs two warm-up steps, then
traces ``--steps`` steps at 224x224 with ``torch.profiler``.  Prints the
wall time per step, the device's busy time (the sum of its kernels' time)
and share of the wall, device time by class (K4, K5, their split
reduction, cuDNN convolutions, the rest) and by kernel, and the host's time
to make one batch (the share the trainer's feeder has to hide); writes a
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

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticImageDataset
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.utils.device import resolve_device

# Kernel names of csrc/fused_conv_bn_bwd.cu: the f32 CUDA-core dgrad/wgrad
# templated on the kernel size, the bf16 tensor-core pairs for 1x1
# (dgrad1_mma_kernel, wgrad1_mma_kernel) and 3x3 (dgrad3_mma_kernel,
# wgrad3_mma_kernel); the split reduction serves all.
_K4 = ("_kernel<1>", "1_mma_kernel<")
_K5 = ("_kernel<3>", "3_mma_kernel<")
_OURS = ("dgrad_kernel<", "wgrad_kernel<", "dgrad1_mma_kernel<", "wgrad1_mma_kernel<",
         "dgrad3_mma_kernel<", "wgrad3_mma_kernel<")
_REDUCE = "sum_splits_kernel"
# Substrings of cuDNN's convolution kernel names on Hopper.
_CONV_NAMES = ("conv", "xmma", "implicit_gemm", "cudnn", "fprop", "dgrad", "wgrad", "nhwc")


def _classify(name: str) -> str:
    if any(k in name for k in _OURS):
        return "K5" if any(s in name for s in _K5) else "K4" if any(
            s in name for s in _K4) else "other"
    if _REDUCE in name:
        return "K4/K5 split reduction"
    if any(s in name.lower() for s in _CONV_NAMES):
        return "cuDNN convolutions"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/profile_image_train")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--unfused", action="store_true")
    p.add_argument("--precision", choices=("bf16", "fp32"), default="bf16")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    B, size = args.batch, 224
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = models.create_model("resnet50", dtype=dtype, fused_convbn=not args.unfused,
                                device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, sgd(model.parameters(), 0.1))
    loader = DataLoader(SyntheticImageDataset(B * (args.steps + 2), image_size=size), B,
                        num_workers=4, drop_last=True)
    t0 = time.perf_counter()
    host = list(loader)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    del host
    for batch in batches[:2]:
        step(batch, 0.1)
    torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[2:]:
            step(batch, 0.1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    tag = "unfused" if args.unfused else "fused (K4, K5)"
    print(f"[profile] card {card}; ResNet-50 {tag} train step B={B} {size}x{size} "
          f"{args.precision} over {args.steps} steps: wall {wall_ms} ms/step, device busy "
          f"{busy_ms} ms/step ({100 * busy_ms / wall_ms:.1f}% of wall), {B / wall_ms * 1e3} "
          f"images/s; max memory allocated {torch.cuda.max_memory_allocated() / 2**30} GiB")
    print(f"[profile] host: {host_ms} ms to make one batch of {B} synthetic images "
          f"(the loader with 4 threads)")
    if not kernels:
        print("[profile] device time: not measured (no device events recorded)")
    classes: dict = {}
    for e in kernels:
        c = classes.setdefault(_classify(e.key), [0.0, 0])
        c[0] += e.self_device_time_total / 1e3 / args.steps
        c[1] += e.count / args.steps
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {name}: {ms} ms/step in {n} launches/step "
              f"({100 * ms / busy_ms if busy_ms else 0:.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:10.3f} ms/step "
              f"{e.count / args.steps:6.0f} x  {e.key[:100]}")
    prof.export_chrome_trace(os.path.join(args.out, "image_train_steps.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
