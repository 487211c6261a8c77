"""K5's two halo layouts timed against each other on the card.

    python -m pytorch_distributed_tpu_torch.tools.k5_halo_layouts [--iters N]

The bf16 3x3 kernels of ``csrc/fused_conv_bn_bwd.cu`` stage a pixel tile's
halo as contiguous rows where wgrad's ring of three such halos fits (planes
up to 106 pixels wide: every ResNet-50 plane), and as the three 130-row
bands the taps touch otherwise (``k5_banded``).  This tool builds a second
copy of the source with the banded layout forced at every width, then, at
ResNet-50 b256's four 3x3 planes (bf16, ReLU), holds the banded kernels
against the plain version and times ``fused_dgrad_wgrad_3x3`` with each
library in the order contiguous, banded, banded, contiguous (CUDA events,
``--iters`` launches each after 2 warm-ups).  Prints the card and one line
per plane.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops import fused_conv_bn as fcb
from pytorch_distributed_tpu_torch.utils.device import resolve_device

_RULE = "bool k5_banded(const Geo& g) { return wgrad3_smem(g, false) > MAX_SMEM; }"
_PLANES = ((56, 64), (28, 128), (14, 256), (7, 512))


def _banded_build():
    """Start nvcc on a copy of the source whose layout rule always bands."""
    src = (_build.CSRC / "fused_conv_bn_bwd.cu").read_text()
    if _RULE not in src:
        raise RuntimeError("the kernel source's halo layout rule has changed")
    out = _build.BUILD_DIR / "k5_banded_everywhere"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "fused_conv_bn_bwd.cu", out / "libfused_conv_bn_bwd_banded.so"
    cu.write_text(src.replace(_RULE, "bool k5_banded(const Geo&) { return true; }"))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def _ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _agree(got, want, atol_frac, rtol):
    got, want = got.float(), want.float()
    ok = (got - want).abs() <= atol_frac * want.abs().max() + rtol * want.abs()
    return bool(ok.all()) and bool(torch.isfinite(got).all())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    proc, so = _banded_build()
    kernel = fcb._kernel
    contiguous = kernel()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the banded copy exited {proc.returncode}:\n{log}")
    banded = ctypes.CDLL(str(so)).ptd_fused_conv_bn_bwd
    banded.restype, banded.argtypes = contiguous.restype, contiguous.argtypes
    libs = {"contiguous": contiguous, "banded": banded}
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, N = torch.bfloat16, 256
    agree = True
    try:
        for hw, c in _PLANES:
            y, do, a = (torch.randn(N, hw, hw, c, device=dev, generator=gen).to(bf16)
                        for _ in range(3))
            w = torch.randn(c, c, 3, 3, device=dev, generator=gen) / math.sqrt(9 * c)
            gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            yf = y.float().reshape(-1, c)
            mu, var = yf.mean(0), yf.var(0, unbiased=False)
            s, t, u, v, _, _ = fcb.bn_bwd_vectors(y, do, mu, torch.rsqrt(var + 1e-5), gamma,
                                                  beta, True)
            fcb._kernel = lambda: libs["banded"]
            da, dw = fcb.fused_dgrad_wgrad_3x3(y, do, a, w, s, t, u, v, True)
            rda, rdw = fcb.fused_dgrad_wgrad_3x3_reference(y, do, a, w, s, t, u, v, True)
            ok = _agree(da, rda, 1e-3, 1e-2) and _agree(dw, rdw, 1e-4, 1e-3)
            agree = agree and ok
            del da, dw, rda, rdw
            times = {"contiguous": [], "banded": []}
            for layout in ("contiguous", "banded", "banded", "contiguous"):
                fcb._kernel = lambda lib=libs[layout]: lib
                times[layout].append(_ms(
                    lambda: fcb.fused_dgrad_wgrad_3x3(y, do, a, w, s, t, u, v, True),
                    args.iters))
            ms = {k: sum(x) / len(x) for k, x in times.items()}
            print(f"[k5 halo] {hw}x{hw}x{c} N={N}: contiguous {ms['contiguous']} ms "
                  f"{times['contiguous']}, banded {ms['banded']} ms {times['banded']}, "
                  f"banded / contiguous {ms['banded'] / ms['contiguous']}; banded agrees "
                  f"with the plain version: {ok}")
            del y, do, a
    finally:
        fcb._kernel = kernel
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
