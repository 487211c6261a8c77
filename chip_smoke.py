#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one NVIDIA H100 and check them.

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
   at the training path's shape and at a ragged non-causal f32 shape, and
   time each kernel, the plain version and the backward of
   ``scaled_dot_product_attention`` (a yardstick only);
6. drive the training path through ``recipes.lm_pretrain`` at the same full
   width (f32 weights, bf16 compute) at sequence length 4096, batch 4, for 8
   steps and a 2-batch eval: every step must launch K1, K2 and K3 once per
   layer, every eval batch K1 once per layer, and every loss be finite;
7. one training step's loss and gradients at full width, 2 layers, B=1,
   L=4096, f32, through the kernels and through dense attention: they must
   agree.

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

from pytorch_distributed_tpu_torch.models.generate import generate, greedy_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from pytorch_distributed_tpu_torch.recipes import lm_generate, lm_pretrain
from pytorch_distributed_tpu_torch.train.lm import lm_loss


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


def _bwd_bounds(B, L, H, D, causal, bf16):
    """Least times of K2 and K3: 6*D (s, dp, dq) and 8*D (s, dp, dv, dk)
    FLOP per attended pair; each reads q, k, v, dO (input dtype), lse and
    delta (f32) once and writes dq, or dk and dv, once."""
    pairs = (L * (L + 1) // 2 if causal else L * L) * B * H
    es = 2 if bf16 else 4
    reads = 4 * B * L * H * D * es + 2 * B * H * L * 4
    return (_roofline_ms(6 * D * pairs, reads + B * L * H * D * es, bf16),
            _roofline_ms(8 * D * pairs, reads + 2 * B * L * H * D * es, bf16))


def _agree(got, want, atol_frac, rtol):
    """(max abs error, |got - want| <= atol_frac * max|want| + rtol * |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol_frac * want.abs().max() + rtol * want.abs()).all())
    return err.max().item(), ok and bool(torch.isfinite(got).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    dev = torch.device("cuda")

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
    # (O and lse from K1).  Tolerances: both sides recompute p and ds in f32
    # and differ in summation order only.  A bf16 gradient may then round
    # one bf16 ulp apart, at most 2^-8 of its size, which rtol 1e-2 covers;
    # atol 1e-3 of the largest |gradient| covers elements near zero, where
    # the f32 order differences of the ~4096-term sums show.  f32 gradients
    # agree to ~1e-6 relative: rtol 1e-4 and atol 1e-5 of the largest.
    bwd_cases = [
        dict(name="path", B=4, L=4096, H=16, D=64, causal=True,
             dtype=torch.bfloat16, atol=1e-3, rtol=1e-2),
        dict(name="ragged", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.float32, atol=1e-5, rtol=1e-4),
    ]
    bwd = {}
    for c in bwd_cases:
        B, L, H, D, causal = c["B"], c["L"], c["H"], c["D"], c["causal"]
        qkv = torch.randn(B, L, 3, H, D, device=dev, generator=gen).to(c["dtype"])
        q, k, v = qkv.unbind(2)
        dout = torch.randn(B, L, H, D, device=dev, generator=gen).to(c["dtype"])
        out, lse = flash_attention(q, k, v, causal)
        delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, causal)
        errs = [_agree(a, b, c["atol"], c["rtol"]) for a, b in zip((dq, dk, dv), ref)]
        del ref, dq, dk, dv
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
        (b_dq, by_dq), (b_dkv, by_dkv) = _bwd_bounds(B, L, H, D, causal,
                                                    c["dtype"] == torch.bfloat16)
        bwd[c["name"]] = dict(
            dq=dict(err=errs[0][0], ms=ms_dq, bound_ms=b_dq, bound_by=by_dq),
            dkv=dict(err=max(errs[1][0], errs[2][0]), ms=ms_dkv, bound_ms=b_dkv,
                     bound_by=by_dkv),
            plain_ms=plain_ms, library_ms=lib_bwd_ms)
        print(f"[bwd kernel] {c['name']} B={B} L={L} H={H} D={D} causal={causal} "
              f"{c['dtype']}: max err dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} dv "
              f"{errs[2][0]:.3e} (atol {c['atol']} of max|ref|, rtol {c['rtol']}); "
              f"K2 {ms_dq} ms (bound {b_dq} ms, {by_dq}), K3 {ms_dkv} ms (bound "
              f"{b_dkv} ms, {by_dkv}), plain {plain_ms} ms, sdpa backward "
              f"{lib_bwd_ms} ms")
        if not all(ok for _, ok in errs):
            raise SystemExit(f"flash backward kernels disagree with their plain "
                             f"version at {c['name']}")
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
