#!/usr/bin/env python3
"""Run the PyTorch port's serving, LM training and image training paths on one
NVIDIA H100 and check them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build every CUDA kernel of the port from ``pytorch_distributed_tpu_torch/csrc``;
2. hold the flash-attention kernel against its plain PyTorch version at the
   serving path's shape and at a ragged non-causal f32 shape, and time the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it);
3. drive the serving path through its entry points at the full width of the
   repo's 183.9M-parameter LM (vocab 32000, d_model 1024, 16 heads, 12
   layers, bf16, seeded random weights): ``generate`` on 4 prompts of 4096
   tokens, then ``recipes.lm_generate.main``; every prefill must launch the
   kernel once per layer;
4. prefill the same weights in f32 through the kernel and through the dense
   cache path: logits and the first greedy tokens must agree;
5. hold the backward kernels (K2 dq, K3 dk/dv) against their plain version
   at the training path's shape and at ragged non-causal bf16 and f32
   shapes, check that two runs at the path shape give identical bits, and
   time each kernel (with its TFLOP/s and share of its bound), the plain
   version and the backward of ``scaled_dot_product_attention`` (a
   yardstick only);
6. drive the training path through ``recipes.lm_pretrain`` at the same full
   width (f32 weights, bf16 compute) at sequence length 4096, batch 4, for 8
   steps and a 2-batch eval: every step must launch K1, K2 and K3 once per
   layer, every eval batch K1 once per layer, and every loss be finite;
7. one training step's loss and gradients at full width, 2 layers, B=1,
   L=4096, f32, through the kernels and through dense attention: they must
   agree;
8. hold the fused conv -> BN backward kernels (K4 1x1, K5 3x3) against
   their plain version at the ResNet-50 b256 bf16 shapes with the most
   bytes (K4: stage 1, 256->64 and 64->256; K5: the 56x56x64 and 7x7x512
   planes) and at ragged f32 shapes (relu on and off), and time each
   kernel, the plain version and cuDNN's convolution backward after dy
   formed in PyTorch (a yardstick only: the port never calls it);
9. drive the image training path through ``recipes.tpu_native`` with
   ``-a resnet50 --synthetic --fused-convbn -b 256 --image-size 224``, bf16,
   for 8 train steps and 1 eval batch of 204 samples padded to 256: every
   step must launch K4 33 times and K5 13 times, eval neither, and every
   loss be finite;
10. one f32 training step (TF32 off) of ResNet-50 at batch 8, fused and
    unfused, from the same weights: loss, every gradient and the updated
    running statistics must agree.

The line before the last lists each kernel with its launches, error and
times; the last line is the device record.  Needs one CUDA card; exits
non-zero without one.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.models.generate import generate, greedy_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.fused_bn import _stats
from pytorch_distributed_tpu_torch.ops.fused_conv_bn import (
    _dy,
    bn_bwd_vectors,
    fused_dgrad_wgrad,
    fused_dgrad_wgrad_3x3,
    fused_dgrad_wgrad_3x3_reference,
    fused_dgrad_wgrad_reference,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from pytorch_distributed_tpu_torch.recipes import lm_generate, lm_pretrain, tpu_native
from pytorch_distributed_tpu_torch.train.lm import lm_loss
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step


def _ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(B, L, H, D, causal, bf16):
    """Least time for attention forward on an H100 SXM: the causal or full
    pairs' 4*D FLOP each over the bf16 tensor-core (989 TFLOP/s) or f32
    (67 TFLOP/s) peak, against q, k, v, O and lse once over 3.35 TB/s."""
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * D * pairs * B * H
    nbytes = 4 * B * L * H * D * (2 if bf16 else 4) + B * H * L * 4
    return _roofline_ms(flops, nbytes, bf16)


def _roofline_ms(flops, nbytes, bf16):
    """max(FLOP over the bf16 tensor-core or f32 peak, bytes over 3.35 TB/s)
    in ms, and which of the two bounds it."""
    t_ops = flops / (989e12 if bf16 else 67e12)
    t_bytes = nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_flops(B, L, H, D, causal):
    """FLOP of K2 and K3: 6*D (s, dp, dq) and 8*D (s, dp, dv, dk) per
    attended pair."""
    pairs = (L * (L + 1) // 2 if causal else L * L) * B * H
    return 6 * D * pairs, 8 * D * pairs


def _bwd_bounds(B, L, H, D, causal, bf16):
    """Least times of K2 and K3: their FLOP over the peak; each reads q, k,
    v, dO (input dtype), lse and delta (f32) once and writes dq, or dk and
    dv, once."""
    es = 2 if bf16 else 4
    reads = 4 * B * L * H * D * es + 2 * B * H * L * 4
    f_dq, f_dkv = _bwd_flops(B, L, H, D, causal)
    return (_roofline_ms(f_dq, reads + B * L * H * D * es, bf16),
            _roofline_ms(f_dkv, reads + 2 * B * L * H * D * es, bf16))


def _conv_bn_bwd_bound(ks, N, H, W, Ci, Co, bf16):
    """Least time of K4 (ks=1) or K5 (ks=3): 2 FLOP per multiply-add of
    dgrad and of wgrad over the (pixel, tap) pairs inside the image; y, do,
    a and the compute-dtype weight read once, the f32 vectors read once, da
    and the f32 dW written once."""
    pairs = N * (3 * H - 2) * (3 * W - 2) if ks == 3 else N * H * W
    es = 2 if bf16 else 4
    M = N * H * W
    nbytes = (M * (2 * Co + 2 * Ci) * es + ks * ks * Ci * Co * (es + 4) + 4 * Co * 4)
    return _roofline_ms(4 * pairs * Ci * Co, nbytes, bf16)


def _agree(got, want, atol_frac, rtol):
    """(max abs error, |got - want| <= atol_frac * max|want| + rtol * |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol_frac * want.abs().max() + rtol * want.abs()).all())
    return err.max().item(), ok and bool(torch.isfinite(got).all())


def _frob(got, want):
    """Relative Frobenius error ||got - want|| / ||want||."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 2. kernel vs plain version.  Tolerances: both sides compute in f32
    # from the same inputs and differ only in summation order, so f32
    # outputs agree to ~1e-6 relative (1e-5 allowed) and lse, of size
    # log L, to 1e-4.  A bf16 output may round one bf16 ulp apart, at most
    # 2^-8 of its size, which rtol 1e-2 covers; atol 2e-3 only has to cover
    # outputs near zero (a typical |o| here is 0.03-0.05).  Each case
    # slices q, k, v out of one [B, L, 3, H, D] tensor, with the strides of
    # the fused qkv projection's views that reach the kernel when serving.
    cases = [
        dict(name="path", B=4, L=4096, H=16, D=64, causal=True,
             dtype=torch.bfloat16, atol=2e-3, rtol=1e-2),
        dict(name="ragged", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.float32, atol=1e-5, rtol=1e-5),
    ]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for c in cases:
        B, L, H, D = c["B"], c["L"], c["H"], c["D"]
        qkv = torch.randn(B, L, 3, H, D, device=dev, generator=gen).to(c["dtype"])
        q, k, v = qkv.unbind(2)
        out, lse = flash_attention(q, k, v, c["causal"])
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, c["causal"])
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok_out = torch.allclose(out.float(), ref_out.float(), atol=c["atol"], rtol=c["rtol"])
        ok_lse = torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)
        del ref_out, ref_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = _ms(lambda: flash_attention(q, k, v, c["causal"]), 20)
        plain_ms = _ms(lambda: flash_attention_reference(q, k, v, c["causal"]), 3, 1)
        lib_ms = _ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=c["causal"]), 20)
        bound, bound_by = _bound_ms(B, L, H, D, c["causal"], c["dtype"] == torch.bfloat16)
        results[c["name"]] = dict(err=err_out, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
        print(f"[kernel] {c['name']} B={B} L={L} H={H} D={D} causal={c['causal']} "
              f"{c['dtype']}: out max err {err_out:.3e} (atol {c['atol']}, rtol "
              f"{c['rtol']}) lse max err {err_lse:.3e} (atol 1e-4); kernel {ms} ms, "
              f"plain {plain_ms} ms, sdpa {lib_ms} ms, bound {bound} ms ({bound_by})")
        if not (ok_out and ok_lse):
            raise SystemExit(f"flash kernel disagrees with its plain version at {c['name']}")
        del qkv, q, k, v, qt, kt, vt, out, lse
    torch.cuda.empty_cache()

    # 3. the serving path at full width, through its entry points
    cfg = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12)
    B, P, N = 4, 4096, 32
    model = TransformerLM(**cfg, dtype=torch.bfloat16, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, cfg["vocab_size"], (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    generate(model, prompt, 2)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    prefills = 0
    reps = []
    for _ in range(3):
        times = {}
        for n_new in (1, N + 1):
            t0 = time.perf_counter()
            toks = generate(model, prompt, n_new)
            torch.cuda.synchronize()
            times[n_new] = (time.perf_counter() - t0) * 1e3
            prefills += 1
            if toks.shape != (B, n_new) or not bool(
                    ((toks >= 0) & (toks < cfg["vocab_size"])).all()):
                raise SystemExit(f"generate returned bad tokens: {toks.shape}")
        reps.append(times)
    recipe_prompt = ",".join(str(t) for t in prompt[0].tolist())
    rc = lm_generate.main([
        "--random-init", "--vocab", "32000", "--d-model", "1024", "--n-heads", "16",
        "--n-layers", "12", "--precision", "bf16", "--prompt-tokens", recipe_prompt,
        "-n", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    prefills += 1
    launches = flash_attention.launches
    if rc != 0:
        raise SystemExit(f"lm_generate.main returned {rc}")
    if launches != cfg["n_layers"] * prefills:
        raise SystemExit(f"flash kernel launched {launches} times for {prefills} "
                         f"prefills of {cfg['n_layers']} layers")
    for times in reps:
        decode_ms = (times[N + 1] - times[1]) / N
        print(f"[serve] B={B} P={P}: prefill + first token {times[1]} ms, decode "
              f"{decode_ms} ms/token, {B / decode_ms * 1e3} tokens/s")
    print(f"[serve] flash launches {launches} over {prefills} prefills; max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30} GiB; card {card}")
    del model
    torch.cuda.empty_cache()

    # 4. flash vs dense prefill on the same weights, f32, TF32 off.  The two
    # paths differ in attention summation order only (~1e-6 relative per
    # layer); 12 layers and logits of O(1) stay well inside 1e-3.
    model = TransformerLM(**cfg, dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    p1 = prompt[:1]
    with torch.no_grad():
        logits = []
        for flash in (True, False):
            cache = model.new_cache(1, P + 4)
            logits.append(model(p1, cache=cache, flash_prefill=flash))
    err = (logits[0] - logits[1]).abs().max().item()
    print(f"[parity] f32 prefill logits flash vs dense: max err {err:.3e} (atol 1e-3, rtol 1e-3)")
    if not torch.allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3):
        raise SystemExit("flash and dense prefill logits disagree")
    del logits
    tf = greedy_generate(model, p1, 4, flash_prefill=True)
    td = greedy_generate(model, p1, 4, flash_prefill=False)
    print(f"[parity] greedy tokens flash {tf.tolist()} dense {td.tolist()}")
    if not torch.equal(tf, td):
        raise SystemExit("flash and dense prefill give different greedy tokens")

    del model
    torch.cuda.empty_cache()
    serve_launches = launches

    # 5. K2, K3 vs their plain version, with the same q, k, v, O, lse and dO
    # (O and lse from K1).  Tolerances.  f32 runs on the CUDA cores: both
    # sides recompute p and ds in f32 and differ in summation order only,
    # ~1e-6 relative: rtol 1e-4 and atol 1e-5 of the largest |gradient|.
    # bf16 runs on the tensor cores, whose second products take p and ds
    # rounded to bf16 (as FlashAttention-2/3 and SDPA's backward do) where
    # the plain version keeps them f32.  Emulated on the CPU
    # (tests/test_torch_flash_attention_bwd.py), that rounding costs ~1.7e-3
    # relative Frobenius error and up to ~1.8e-3 of max|gradient| past rtol
    # 1e-2; each side's bf16 output rounding adds ~1.7e-3 Frobenius, ~2.6e-3
    # in all.  So bf16 holds atol 4e-3 of the largest |gradient| + rtol 1e-2
    # per element and a relative Frobenius error <= 5e-3 per gradient; a
    # wrong tile or mask gives errors of order 1.
    bwd_cases = [
        dict(name="path", B=4, L=4096, H=16, D=64, causal=True,
             dtype=torch.bfloat16, atol=4e-3, rtol=1e-2, frob=5e-3),
        dict(name="ragged_bf16", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.bfloat16, atol=4e-3, rtol=1e-2, frob=5e-3),
        dict(name="ragged", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.float32, atol=1e-5, rtol=1e-4, frob=None),
    ]
    bwd = {}
    for c in bwd_cases:
        B, L, H, D, causal = c["B"], c["L"], c["H"], c["D"], c["causal"]
        qkv = torch.randn(B, L, 3, H, D, device=dev, generator=gen).to(c["dtype"])
        q, k, v = qkv.unbind(2)
        dout = torch.randn(B, L, H, D, device=dev, generator=gen).to(c["dtype"])
        out, lse = flash_attention(q, k, v, causal)
        delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
        grads = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal),
                 *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal))
        torch.cuda.synchronize()
        ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, causal)
        errs = [_agree(a, b, c["atol"], c["rtol"]) for a, b in zip(grads, ref)]
        frobs = [_frob(a, b) for a, b in zip(grads, ref)]
        ok = all(ok for _, ok in errs) and (c["frob"] is None or max(frobs) <= c["frob"])
        same = None
        if c["name"] == "path":
            again = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal),
                     *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal))
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            del again
        del ref, grads
        ms_dq = _ms(lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal), 20)
        ms_dkv = _ms(lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal), 20)
        plain_ms = _ms(lambda: flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                             causal), 3, 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        gt = dout.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            torch.autograd.grad(o, (qt, kt, vt), gt)

        lib_bwd_ms = _ms(sdpa_fwd_bwd, 20) - _ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 20)
        bf16_case = c["dtype"] == torch.bfloat16
        (b_dq, by_dq), (b_dkv, by_dkv) = _bwd_bounds(B, L, H, D, causal, bf16_case)
        f_dq, f_dkv = _bwd_flops(B, L, H, D, causal)
        bwd[c["name"]] = dict(
            dq=dict(err=errs[0][0], ms=ms_dq, bound_ms=b_dq, bound_by=by_dq),
            dkv=dict(err=max(errs[1][0], errs[2][0]), ms=ms_dkv, bound_ms=b_dkv,
                     bound_by=by_dkv),
            plain_ms=plain_ms, library_ms=lib_bwd_ms)
        print(f"[bwd kernel] {c['name']} B={B} L={L} H={H} D={D} causal={causal} "
              f"{c['dtype']}: max err dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} dv "
              f"{errs[2][0]:.3e} (atol {c['atol']} of max|ref|, rtol {c['rtol']}); "
              f"relative Frobenius dq {frobs[0]:.3e} dk {frobs[1]:.3e} dv {frobs[2]:.3e} "
              f"(limit {c['frob']}); K2 {ms_dq} ms, {f_dq / ms_dq / 1e9} TFLOP/s, "
              f"{100 * b_dq / ms_dq}% of its bound {b_dq} ms ({by_dq}); K3 {ms_dkv} ms, "
              f"{f_dkv / ms_dkv / 1e9} TFLOP/s, {100 * b_dkv / ms_dkv}% of its bound "
              f"{b_dkv} ms ({by_dkv}); plain {plain_ms} ms, sdpa backward {lib_bwd_ms} ms"
              + ("" if same is None else f"; two runs bit-identical: {same}"))
        if not ok:
            raise SystemExit(f"flash backward kernels disagree with their plain "
                             f"version at {c['name']}")
        if same is False:
            raise SystemExit("flash backward kernels gave different bits on a rerun")
        del qkv, q, k, v, dout, out, lse, delta, qt, kt, vt, gt
    torch.cuda.empty_cache()

    # 6. the training path at full width, through the recipe
    steps, eval_batches, TB, TL = 8, 2, 4, 4096
    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer = lm_pretrain.run([
        "--vocab", "32000", "--d-model", "1024", "--n-heads", "16", "--n-layers", "12",
        "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision", "bf16",
        "--eval-batches", str(eval_batches), "-p", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    train_launches = (flash_attention.launches, flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches)
    want = (cfg["n_layers"] * (steps + eval_batches), cfg["n_layers"] * steps,
            cfg["n_layers"] * steps)
    if train_launches != want:
        raise SystemExit(f"training launched (K1, K2, K3) {train_launches} times, "
                         f"expected {want}")
    losses = [float(x) for x in trainer.losses]
    eval_loss = trainer.eval_history[-1][0]
    if not all(math.isfinite(x) for x in losses + [eval_loss]):
        raise SystemExit(f"non-finite training loss: {losses}, eval {eval_loss}")
    step_ms = statistics.median(trainer.step_times[1:]) * 1e3
    print(f"[train] B={TB} L={TL} bf16 compute, f32 weights: step {step_ms} ms (median "
          f"of steps 2-{steps}; all {[t * 1e3 for t in trainer.step_times]}), "
          f"{TB * TL / step_ms * 1e3} tokens/s; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB; losses {losses}, eval "
          f"loss {eval_loss}; launches K1/K2/K3 {train_launches}; card {card}")
    del trainer
    torch.cuda.empty_cache()

    # 7. flash vs dense training gradients on the same weights, f32, TF32
    # off.  The two paths differ in attention summation order only (~1e-6
    # relative); each gradient must agree to 1e-3 of its largest entry.
    grads, weights = {}, None
    for impl in ("flash", "dense"):
        model = TransformerLM(**dict(cfg, n_layers=2), dtype=torch.float32,
                              device=dev, attn_impl=impl)
        if weights is None:
            weights = model.init_weights(
                torch.Generator(device=dev).manual_seed(0)).state_dict()
        else:
            model.load_state_dict(weights)
        loss = lm_loss(model, prompt[:1])[0]
        loss.backward()
        grads[impl] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
        del model, loss
    del weights
    loss_err = abs(grads["flash"][0] - grads["dense"][0]) / abs(grads["dense"][0])
    rel = {n: ((g - grads["dense"][1][n]).abs().max()
               / grads["dense"][1][n].abs().max()).item()
           for n, g in grads["flash"][1].items()}
    worst = max(rel, key=rel.get)
    print(f"[parity] f32 train step flash vs dense (2 layers, B=1, L={P}): loss "
          f"{grads['flash'][0]} vs {grads['dense'][0]} (rel err {loss_err:.3e}); "
          f"worst gradient {worst} rel err {rel[worst]:.3e} (limit 1e-3 of its max)")
    # Written so that a NaN fails: every comparison with NaN is false.
    if not (loss_err <= 1e-5 and all(r <= 1e-3 for r in rel.values())):
        raise SystemExit("flash and dense training gradients disagree")

    # 8. K4, K5 vs their plain version.  Inputs are random; s, t, u, v come
    # from bn_bwd_vectors on the batch statistics of y, as on the path, so
    # the ReLU mask is live.  Tolerances: dy is formed with the same
    # roundings on both sides and the products differ in summation order
    # only, so a bf16 da may round one ulp (2^-8 relative) apart: rtol 1e-2,
    # atol 1e-3 of max|ref| for entries near zero; dW is f32 on both sides,
    # sums of up to 802,816 terms in another order: atol 1e-4 of max|ref|,
    # rtol 1e-3.  f32 ragged shapes: atol 1e-5 of max|ref|, rtol 1e-4.
    bf16 = torch.bfloat16
    conv_cases = [
        dict(name="k4_path", ks=1, N=256, H=56, W=56, Ci=256, Co=64, dtype=bf16, relu=True),
        dict(name="k4_64_256", ks=1, N=256, H=56, W=56, Ci=64, Co=256, dtype=bf16,
             relu=False),
        dict(name="k5_path", ks=3, N=256, H=56, W=56, Ci=64, Co=64, dtype=bf16, relu=True),
        dict(name="k5_7x7_512", ks=3, N=256, H=7, W=7, Ci=512, Co=512, dtype=bf16,
             relu=True),
        dict(name="k4_ragged_relu", ks=1, N=3, H=9, W=11, Ci=70, Co=33,
             dtype=torch.float32, relu=True),
        dict(name="k4_ragged", ks=1, N=3, H=9, W=11, Ci=70, Co=33,
             dtype=torch.float32, relu=False),
        dict(name="k5_ragged_relu", ks=3, N=3, H=9, W=11, Ci=70, Co=33,
             dtype=torch.float32, relu=True),
        dict(name="k5_ragged", ks=3, N=3, H=9, W=11, Ci=70, Co=33,
             dtype=torch.float32, relu=False),
    ]
    conv = {}
    for c in conv_cases:
        ks, N, H, W, Ci, Co, dt, relu = (c[k] for k in ("ks", "N", "H", "W", "Ci", "Co",
                                                       "dtype", "relu"))
        y = torch.randn(N, H, W, Co, device=dev, generator=gen).to(dt)
        do = torch.randn(N, H, W, Co, device=dev, generator=gen).to(dt)
        a = torch.randn(N, H, W, Ci, device=dev, generator=gen).to(dt)
        w = torch.randn(Co, Ci, ks, ks, device=dev, generator=gen) / math.sqrt(Ci * ks * ks)
        gamma = 1.0 + 0.1 * torch.randn(Co, device=dev, generator=gen)
        beta = 0.1 * torch.randn(Co, device=dev, generator=gen)
        mu, var = _stats(y)
        s, t, u, v, _, _ = bn_bwd_vectors(y, do, mu, torch.rsqrt(var + 1e-5), gamma, beta,
                                          relu)
        kernel, plain = ((fused_dgrad_wgrad, fused_dgrad_wgrad_reference) if ks == 1 else
                         (fused_dgrad_wgrad_3x3, fused_dgrad_wgrad_3x3_reference))
        args = (y, do, a, w, s, t, u, v, relu)
        da, dw = kernel(*args)
        torch.cuda.synchronize()
        rda, rdw = plain(*args)
        atol, rtol = ((1e-3, 1e-2) if dt == bf16 else (1e-5, 1e-4))
        e_da, ok_da = _agree(da, rda, atol, rtol)
        e_dw, ok_dw = _agree(dw, rdw, 1e-4 if dt == bf16 else 1e-5, 1e-3 if dt == bf16 else 1e-4)
        del da, dw, rda, rdw
        ms = _ms(lambda: kernel(*args), 20)
        plain_ms = _ms(lambda: plain(*args), 20)
        wc = w.to(dt)
        a_nchw = a.permute(0, 3, 1, 2)

        def library():
            dy = _dy(y, do, s, t, u, v, relu, dt).permute(0, 3, 1, 2)
            torch.ops.aten.convolution_backward(dy, a_nchw, wc, None, [1, 1], [ks // 2] * 2,
                                                [1, 1], False, [0, 0], 1,
                                                [True, True, False])

        lib_ms = _ms(library, 20)
        bound, bound_by = _conv_bn_bwd_bound(ks, N, H, W, Ci, Co, dt == bf16)
        conv[c["name"]] = dict(err=max(e_da, e_dw), ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
        print(f"[conv-bn kernel] {c['name']} K{4 if ks == 1 else 5} N={N} H={H} W={W} "
              f"Ci={Ci} Co={Co} {dt} relu={relu}: max err da {e_da:.3e} dW {e_dw:.3e}; "
              f"kernel {ms} ms, plain {plain_ms} ms, dy + cuDNN backward {lib_ms} ms, "
              f"bound {bound} ms ({bound_by})")
        if not (ok_da and ok_dw):
            raise SystemExit(f"fused conv-BN kernel disagrees with its plain version at "
                             f"{c['name']}")
        del y, do, a, w, wc, a_nchw, args
    torch.cuda.empty_cache()

    # 9. the image training path at full ResNet-50 width, through the recipe
    steps, per_step = 8, (33, 13)
    fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    image = tpu_native.run([
        "-a", "resnet50", "--synthetic", "--fused-convbn", "-b", "256", "--image-size", "224",
        "--synthetic-length", str(256 * steps), "--epochs", "1", "--precision", "bf16",
        "--seed", "0", "-p", "1", "--epoch-csv", "build/tpu_native_smoke.csv",
        "--device", "cuda"])
    torch.cuda.synchronize()
    image_launches = (fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches)
    want = (per_step[0] * steps, per_step[1] * steps)
    if image_launches != want or len(image.losses) != steps:
        raise SystemExit(f"image training launched (K4, K5) {image_launches} times in "
                         f"{len(image.losses)} steps and one eval batch, expected {want}")
    # Eval alone, once more on the same trainer: no backward, so neither
    # kernel may launch.
    fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
    image.validate()
    torch.cuda.synchronize()
    eval_launches = (fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches)
    if eval_launches != (0, 0):
        raise SystemExit(f"image eval launched (K4, K5) {eval_launches} times, expected none")
    losses = [float(x) for x in image.losses]
    eval_loss, acc1, acc5 = image.eval_history[0]
    if not all(math.isfinite(x) for x in losses + [eval_loss]):
        raise SystemExit(f"non-finite image training loss: {losses}, eval {eval_loss}")
    step_ms = statistics.median(image.step_times[1:]) * 1e3
    print(f"[image train] ResNet-50 --fused-convbn B=256 224x224 bf16 compute, f32 weights: "
          f"step {step_ms} ms (median of steps 2-{steps}; all "
          f"{[t * 1e3 for t in image.step_times]}), {256 / step_ms * 1e3} images/s; host "
          f"wait for batches {image.feeder.wait_s} s over the run; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB; losses {losses}; eval loss "
          f"{eval_loss} Acc@1 {acc1} Acc@5 {acc5} over {len(image.val_loader)} batch of "
          f"{len(image.val_set)} samples; launches K4/K5 {image_launches}; card {card}")
    del image
    torch.cuda.empty_cache()

    # 10. fused vs unfused f32 training step on the same weights, TF32 off.
    # The two differ in the conv backward's summation order only (~1e-7
    # relative per product); through 53 conv -> BN layers each gradient
    # must agree to 1e-3 of its largest entry, the loss to 1e-5 relative.
    # The forward is the same code on both sides, so the running
    # statistics must agree to 1e-6 of their largest entry.
    pb = 8
    pgen = torch.Generator(device=dev).manual_seed(3)
    batch = {"images": torch.rand(pb, 224, 224, 3, device=dev, generator=pgen),
             "labels": torch.randint(0, 1000, (pb,), device=dev, generator=pgen),
             "weights": torch.tensor([1.0] * (pb - 2) + [0.0] * 2, device=dev)}
    runs, weights = {}, None
    for fused in (True, False):
        model = models.create_model("resnet50", fused_convbn=fused, device=dev)
        if weights is None:
            model.init_weights(torch.Generator(device=dev).manual_seed(0))
            weights = {k: t.clone() for k, t in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        metrics = make_train_step(model, sgd(model.parameters(), 0.1))(batch, 0.1)
        runs[fused] = (metrics["loss"].item(),
                       {n: p.grad for n, p in model.named_parameters()},
                       {n: b.clone() for n, b in model.named_buffers()})
        del model
    del weights
    (lf, gf, bf), (lu, gu, bu) = runs[True], runs[False]
    loss_err = abs(lf - lu) / abs(lu)
    rel = {n: ((g - gu[n]).abs().max() / gu[n].abs().max().clamp_min(1e-30)).item()
           for n, g in gf.items()}
    stat_rel = max(((b - bu[n]).abs().max() / bu[n].abs().max()).item() for n, b in bf.items())
    worst = max(rel, key=rel.get)
    print(f"[parity] f32 ResNet-50 train step fused vs unfused (B={pb}, 224x224, 2 padded "
          f"slots): loss {lf} vs {lu} (rel err {loss_err:.3e}); worst gradient {worst} rel "
          f"err {rel[worst]:.3e} (limit 1e-3 of its max); running statistics rel err "
          f"{stat_rel:.3e} (limit 1e-6)")
    if not (loss_err <= 1e-5 and all(r <= 1e-3 for r in rel.values()) and stat_rel <= 1e-6):
        raise SystemExit("fused and unfused ResNet-50 training steps disagree")
    del runs, gf, gu, bf, bu
    torch.cuda.empty_cache()

    path = results["path"]
    kernels = [dict(
        name="flash_attention_fwd", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="pytorch_distributed_tpu/ops/flash_attention.py:37",
        launches=serve_launches + train_launches[0], max_abs_err=path["err"],
        ms=path["ms"], plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
        bound_by=path["bound_by"], library_ms=path["library_ms"])]
    bpath = bwd["path"]
    for name, key, line, n in (("flash_attention_bwd_dq", "dq", 185, train_launches[1]),
                               ("flash_attention_bwd_dkv", "dkv", 214, train_launches[2])):
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"pytorch_distributed_tpu/ops/flash_attention.py:{line}",
            launches=n, max_abs_err=bpath[key]["err"], ms=bpath[key]["ms"],
            plain_ms=bpath["plain_ms"], bound_ms=bpath[key]["bound_ms"],
            bound_by=bpath[key]["bound_by"], library_ms=bpath["library_ms"]))
    for name, key, line, n in (("fused_dgrad_wgrad", "k4_path", 122, image_launches[0]),
                               ("fused_dgrad_wgrad_3x3", "k5_path", 210, image_launches[1])):
        kp = conv[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_tpu_torch/csrc/fused_conv_bn_bwd.cu",
            replaces=f"pytorch_distributed_tpu/ops/fused_conv_bn.py:{line}",
            launches=n, max_abs_err=kp["err"], ms=kp["ms"], plain_ms=kp["plain_ms"],
            bound_ms=kp["bound_ms"], bound_by=kp["bound_by"], library_ms=kp["library_ms"]))
    print(f"[time] phases 1-10 took {time.perf_counter() - t_start} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
