#!/usr/bin/env python3
"""Run the PyTorch port's serving, LM training and image training paths,
their checkpoints, image training from an ImageFolder tree on disk, the
data-parallel image recipes, the fused CE head, int8 weights,
speculative decoding, the gradient-communication stack, the rest of the
image zoo, LM training across ranks, the training metrics stream, the
run's death paths and live plane, the serving side's observability and
fleet and the divergence guard's rollback with its report, on one NVIDIA
H100 and check them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build every CUDA kernel of the port from ``pytorch_distributed_tpu_torch/csrc``;
2. hold the flash-attention kernel against its plain PyTorch version at the
   serving path's shape and at ragged non-causal bf16 and f32 shapes, check
   that two runs at the path shape give identical bits, and time the kernel
   (with its TFLOP/s and share of its bound), the plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it);
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
   their plain version at ResNet-50 b256 bf16 shapes (K4: all twelve 1x1
   shapes of the image path, 64->64, 64->256, 256->64 and 256->128 at
   56x56, 128->512, 512->128 and 512->256 at 28x28, 256->1024, 1024->256
   and 1024->512 at 14x14, 2048->512 and 512->2048 at 7x7; K5: all four
   3x3 planes), at the non-square planes the slot rule folds (64x112x64,
   1x2656x64, 1x1219x256), at ragged bf16 shapes and at ragged f32 shapes
   (relu on and off), check that two runs of every bf16 case give
   identical bits, and time each kernel (with its TFLOP/s and share of its
   bound), the plain version and cuDNN's convolution backward after dy
   formed in PyTorch (a yardstick only: the port never calls it); sum K4's
   times and bounds over one image step's 33 launches;
9. drive the image training path through ``recipes.tpu_native`` with
   ``-a resnet50 --synthetic --fused-convbn -b 256 --image-size 224``, bf16,
   for 8 train steps and 1 eval batch of 204 samples padded to 256 (its
   epoch-end checkpoint goes to a temporary ``--checkpoint-dir``, deleted
   after): every step must launch K4 33 times and K5 13 times, eval
   neither, and every loss be finite;
10. one f32 training step (TF32 off) of ResNet-50 at batch 8, fused and
    unfused, from the same weights: loss, every gradient and the updated
    running statistics must agree;
11. time the bf16 ResNet-50 b256 224x224 training step fused and unfused
    (f32 weights, the same seeded weights and synthetic batches, copied to
    the card beforehand): 2 warm-up steps, then the median of 7 steps, each
    closed by a synchronise.  A measurement only: it fails nothing;
12. drive the paged continuous-batching serving engine
    (``serving.engine.ServingEngine``) at the LM's full width in f32, as
    the JAX engine serves, with 16 slots, 16-token blocks, a 1024-token
    window, 128-token prefill chunks and a pool of 384 usable blocks,
    through a seeded mixed trace of 64 requests (prompts 128-512 tokens,
    outputs 16-64, one in five 256-384) arriving at 200 requests/s: every
    request must complete with at least one preemption, the decode step be
    captured once as a CUDA graph and replayed once per decode iteration,
    static mode emit the same tokens, the first 8 requests agree with the
    dense KV-cache path (``greedy_generate``) on at least 90% of their
    tokens, up to a first difference only where its top-2 logit gap is
    under 1e-3, and
    ``serving.serve_lm.main`` serve 16 requests; none of K1-K5 may launch.
    Prints tokens/s, TTFT and ITL percentiles, decode-step wall time and
    the device-busy share of a decode step (CUDA events around each graph
    replay), prefill ms per chunk, preemptions, defrags and peak memory;
13. checkpoints at full width, every file under a temporary directory
    deleted after (~3 GB with rotation), in the JAX package's msgpack
    format: (a) ``recipes.lm_pretrain`` of the 183.9M LM (L=4096, B=4, bf16
    compute, f32 weights, no eval) for 6 steps, again for 4 steps with
    ``--save-steps 2 --checkpoint-dir``, then ``--resume`` to step 6: the
    resumed run must launch K1, K2 and K3 once per layer per step, and its
    losses, weights and momentum equal the uninterrupted run's (bitwise
    expected; anything worse than loss rel 1e-6, weights rtol 1e-6 / atol
    1e-7 fails); prints the file's size and its save and load times;
    (b) ``recipes.lm_generate --resume`` on the resumed run's file must give
    the greedy tokens of the same weights in memory, prefilling 4096
    tokens through K1 once per layer; (c) ``serving.serve_lm --checkpoint``
    on that file must complete 16 requests; (d) ResNet-50 ``--fused-convbn``
    b256 bf16, cuDNN deterministic: a 4-step epoch stopped by the trainer's
    own API after step 2 (where ``--save-steps 2`` saved) and resumed must
    launch K4 33 and K5 13 times per step and end equal to an uninterrupted
    epoch under the same rule;
14. run the ``bench.py`` twin (``tools/bench.py``: ResNet-50 b256 bf16
    synthetic step, unfused then fused) and print its JSON line tagged
    ``[bench]``; a non-finite loss or a failed variant fails the run;
15. image data from disk: print the libjpeg and libwebp the C++ plane
    links (none fails the run); decode each committed fixture
    (``tests/data/images``: JPEGs, gray and CMYK included, and PNG twins)
    twice (same pixels required) and time decode and PIL's bilinear resize
    per image; link the fixtures into an ImageFolder tree of 1000 classes,
    1280 train and 204 val images (deleted after); drive
    ``recipes.tpu_native --data`` with ``-a resnet50 --fused-convbn -b 256
    --image-size 224``, bf16, once per ``--wire`` (f32, u8host, u8 with
    ``--worker-type process``, and native): 5
    train steps and one eval batch each, K4 33 and K5 13 times per step,
    neither in eval, finite losses; prints per mode the loader's host
    images/s alone, the median step, ``DeviceFeeder`` wait per batch and the
    bytes copied per batch.  The process workers import what they
    unpickle, not this script (the loader's ``_spawn_without_main``).  The
    first eval batch of u8host and u8, as it
    lands on the card, must equal f32's to 1e-5; u8's first train batch
    must follow the JAX flip stream and equal u8host's to 1e-5, and each
    f32 train image the same crop (or its mirror: f32 flips per sample);
    native's eval batch must stay within the JAX test's bound of the
    PIL-exact one (mean |difference| < 4 of 255) with exactly its CMYK and
    PNG-named-JPEG slots masked;
16. data parallelism at full width: each of ``distributed`` and
    ``apex_distributed`` (under ``torch.distributed.run
    --nproc_per_node=1``), ``multiprocessing_distributed`` and
    ``dataparallel`` (plain: one worker per card), ``horovod_distributed``
    (``PTD_TPU_*`` for one process), ``distributed_slurm_main``
    (``SLURM_PROCID=0 SLURM_NTASKS=1``) and ``tpu_native`` (no launcher)
    trains ResNet-50 ``--fused-convbn`` 224x224 synthetic for 3 steps and
    one eval batch in a process of its own (cuDNN deterministic; the two
    timed recipes, ``distributed`` and ``tpu_native``, at b256 alone on the
    card, the other five at b64 together): NCCL
    must be the backend (no group for ``tpu_native``), K4 run 33 and K5 13
    times per step (counted in that process, zeroed just before the run),
    the losses be finite; ``distributed`` (``--precision bf16``) must end
    bitwise equal to ``tpu_native``; ``multiprocessing_distributed`` at two
    ranks of b32 sharing the card over gloo must match one rank of b64
    (f32, TF32 off) within ``WORLD_*`` (loss, weights and statistics, and
    each tensor's difference relative to its change in the run), limits set
    between the sound run's readings and those of two controls run beside
    it (all seven processes at once), which must exceed them: per-rank
    BatchNorm (plain DDP) and K4/K5's per-channel vectors from this rank's
    sums alone.  Prints the DDP step
    against the launcher-less one on one device batch and the all-reduce
    time of ResNet-50's gradients.  Then ``--sync-bn`` on the explicit step
    (``horovod_distributed``, f32, TF32 off, ``--grad-compress none``,
    without ``--fused-convbn``, which it refuses with the JAX message): at
    world 1 over NCCL bitwise equal to the run without it; 2 gloo ranks of
    b32 with it within ``WORLD_*`` of that run, and the same ranks without
    it (per-rank BatchNorm, the control) outside them (the four runs at
    once);
17. the fused tied-head cross-entropy at the LM's full width (L=4096, B=4):
    one f32 step (TF32 off) with ``--fused-ce 8``'s loss against the
    unfused head on the same weights and tokens (loss 1e-5 relative; the
    gradients of ``embed``, ``ln_f`` and the last block 1e-3 of their
    largest), then ``recipes.lm_pretrain`` bf16 for 8 steps with
    ``--fused-ce 8`` and without: K1, K2 and K3 once per layer per step;
    prints step time, tokens/s and peak memory of each;
18. ``generate`` with int8 weight-only block kernels (``quantize_lm``) at
    the serving cell (bf16, 4 prompts of 4096 tokens, 32 new tokens): K1
    once per layer per prefill; greedy tokens equal to those of the
    dequantized weights ``w_q * scale`` in the same dtype up to each row's
    first difference, which must sit where that run's top-2 logit gap is
    under ``INT8_BF16_GAP`` in bf16 and 1e-3 in f32; prints prefill and
    decode times and the parameter bytes against the bf16 model.  Then
    ``speculative_generate`` (batch 1, 512-token prompt, 64 tokens, gamma
    4, f32, TF32 off) with the default random draft (a quarter of the
    width and depth) and with the target as its own draft: the target's
    greedy stream under the same rule (1e-3), the self draft at least
    0.9 * (gamma + 1) tokens per target pass; and ``recipes.lm_generate
    --quant int8 --spec-draft random``;
19. phase 12's engine on its trace cut to 16 requests, plain, at
    ``quant="int8"`` and with ``gamma=3`` and a one-layer draft of
    ``serve_lm``'s default head dim (4: 64 wide at 16 heads; ``serve_lm``'s
    16-wide default would make 1-wide heads): each a single captured graph replayed per
    iteration; the speculative engine's tokens equal the plain engine's,
    the int8 engine's the int8 dense path's on 90% of the first 8
    requests, both under the 1e-3 top-2 rule; ``serve_lm.main --quant int8
    --gamma 3`` serves 8 requests; none of K1-K5 launches;
20. the gradient-communication stack at full width: ``horovod_distributed
    --zero wus --grad-compress none --sync-bn`` (f32, TF32 off, unfused) at
    2 gloo ranks of b128 sharing the card within ``WORLD_*`` of 1 rank of
    b256, each rank
    holding at most half the replicated momentum plus a block of padding a
    leaf; then, in one worker process at world 1 over NCCL (cuDNN
    deterministic, bf16 compute, 3 steps each), ``horovod_distributed``
    with its bf16 wire, ``--grad-compress int8`` and ``fp8``, ``--zero
    wus`` (bf16 wire, and with int8), ``--overlap bucketed --bucket-mb 4``,
    the f32 wire plain, bucketed and with ``--zero wus``, and
    ``distributed --zero wus`` (the GSPMD twin): K4 33 and K5 13 times a
    step, finite losses, the f32 bucketed and ZeRO runs bitwise equal to
    the plain f32 one, int8's first update bitwise equal to the plain
    ``fake_quantize(fake_quantize(g)) / count + wd * w`` chain; an int8
    epoch stopped after 2 of 4 steps and resumed ends bitwise where the
    uninterrupted one does, residual included; ``lm_pretrain`` at the LM
    cell for 8 steps with ``--grad-compress int8`` and with ``--overlap
    bucketed --grad-compress int8``: K1-K3 once per layer per step, finite
    losses.  Prints each variant's step against its baseline (the bf16
    wire; phase 17's unfused LM step), the sync stage alone and the
    bucket count.
21. the rest of the image zoo (``models/{simple,densenet,mobilenet,extra,
    inception,vit}.py``): every one of the 29 archs beyond the ResNets built
    on the card at its published width, one bf16 train step at b16 (64 px;
    Inception-v3 96) with a finite loss, and its f32 eval logits (TF32 off)
    within 1e-3 of the largest of the CPU's for the same weights and images;
    ``recipes.tpu_native`` with ``-a`` vgg16_bn (b64), densenet121 (b128),
    mobilenet_v2 (b128), inception_v3 (299x299, b64), shufflenet_v2_x1_0
    (b128) and vit_b_16 (b64), bf16, synthetic, 3 steps and one eval batch
    each with finite train losses, then its train step alone timed (median of 3
    synchronised steps; prints ms and images/s); ``multiprocessing_distributed
    -a mobilenet_v2`` (BatchNorm and dropout) at 2 gloo ranks of b64 on the
    card against 1 rank of b128 over NCCL, f32, TF32 off, one step, within
    phase 16's ``WORLD_*`` limits, while two controls (per-rank BatchNorm;
    DDP's hook returning this rank's gradient unsummed) must each fall
    outside one, and a chaos probe (1 rank, images x (1 + 1e-7), against
    itself) prints what rounding-sized noise moves; none of K1-K5 launches
    in the phase;
22. LM training across ranks: ``recipes.lm_pretrain`` at the LM cell
    (bf16, 12 layers, B=4, L=4096, 3 steps) in a process of its own under
    ``PTD_TPU_*`` at world 1 (NCCL, the mesh's data group running every
    collective) bitwise equal to the run without a group in this process,
    K1, K2 and K3 once per layer per step in each, its step against phase
    17's unfused one; two gloo ranks sharing the card (f32, TF32 off, the
    LM width at 2 layers, L=4096, 3 steps) against one rank on the same
    global batch: data parallelism (B=4), Megatron tensor parallelism (B=2,
    8 heads a rank through K1-K3), FSDP and ``--zero wus`` at DP 2, each
    within ``LM_WORLD_*`` (every step's loss relative, the whole gathered
    model after the last step absolute), and two controls outside them (qkv split in contiguous
    halves, not head groups; per-rank loss means with no gradient sum);
    each rank's resident parameter and momentum bytes (FSDP 2 under 0.55 of
    DP 2's); ``recipes.lm_generate --tp 2`` at the LM's width and depth
    (f32, two gloo ranks, dense prefill) against ``--tp 1``: the same
    greedy tokens unless the top-2 gap at the first difference is under
    1e-3, printed by rank 0 alone;
23. the training metrics stream: ``recipes.tpu_native -a resnet50
    --fused-convbn`` (b256, 224x224, bf16, synthetic) and
    ``recipes.lm_pretrain`` at the LM cell (B=4, L=4096, bf16), without
    and then with ``--metrics-jsonl --hb-dir --mfu --goodput
    --step-attr`` (the image run also ``--telemetry-csv --profile-dir
    --profile-steps 2:3``), 16 steps each: one record per step with finite
    MFU in (0, 100] and HFU >= MFU against the card's 989 TFLOP/s, the
    attribution identity
    within 0.5% of each step, the image step's compute share >= 90%, one
    heartbeat file at the last step, telemetry rows at the card's total
    memory with peak >= in use > 0, a Chrome trace naming K4's and K5's
    kernels and the ``train_step`` span, K4 33 and K5 13 times a step, K1-K3
    once per layer per step; prints the median step with the flags against
    without and the MFU readings;
24. the death paths and the live plane: (a) ``recipes.lm_pretrain`` at the
    LM cell and (b) ``recipes.tpu_native -a resnet50 --fused-convbn`` (b256,
    224x224, bf16), 16 steps each, with ``--metrics-jsonl --flight-rec
    --hang-timeout 30 --metrics-port P --alerts default`` and the default
    SIGTERM guard, the hub draining every record and a thread scraping
    ``/metrics`` and ``/healthz`` every 0.5 s: at least 2 scrapes with
    ``ptd_up 1`` and a rising ``ptd_step``, every scraped loss the record's
    (at the exposition's 6 digits), ``/healthz`` 200 once a record arrived,
    no alert, no watchdog firing, no dump, K1-K3 12 a step in (a), K4 33 and
    K5 13 in (b); prints the median step against phase 23's without flags.
    (c) the JAX hang story at two gloo ranks sharing the card (DP 2, the LM
    width at 2 layers, bf16, B=4, L=4096): rank 1 stalls 4 s before its
    step-3 collective and SIGTERMs itself; rank 0's watchdog (1 s) dumps
    ``hang`` inside step 3, rank 1 dumps ``signal:15`` one collective
    behind, its watchdog (300 s) silent; the agreement stops both at step 4
    with a checkpoint there; rank 0's records hold the ``hang`` event and
    the ``hang`` rule's alert; ``tools/postmortem.py`` over the dumps and
    heartbeats blames rank 1; K1-K3 once per layer per step on each rank;
25. the serving side's observability and fleet, f32, TF32 off: (a) phase
    12's engine cell through ``serving.serve_lm.serve``, plain (with
    ``--metrics-jsonl``) and then with ``--req-trace --trace-sample 1.0``,
    a ``--slo-ttft-ms`` ceiling over twice the plain run's largest TTFT,
    ``--slo-kv-pct 100`` and the watchdog: the same tokens, 64
    ``reqtrace`` records whose TTFT components sum to their TTFT within
    5%, one ``serve_decode`` capture, no ``recompile`` and no ``alert``; a
    planted second capture must book one ``recompile``, and a third run
    under a ceiling of 0.8 x the traced run's TTFT p99 must book
    ``ttft_p99`` alerts, its own p50 below the ceiling and its p99 above;
    prints tokens/s with and without tracing and the SLO rules.  (b) two
    ``tools/serve_fleet.py replica --engine --device cuda --req-trace``
    processes at the LM's width and seed share the card behind the fleet
    router (``tools/chaoskit.py::replica_kill``): 32 seeded requests,
    then the same prompts with replica 1 SIGKILLed after the 4th
    completion while its engine holds requests: none lost or completed
    twice, the tokens of the unkilled run (identical unless the dense
    top-2 gap at the first difference is under 1e-3), the killed run's
    router TTFT p99 within 3x the unkilled run's + 250 ms, a
    ``replica_down`` event and alert, every ``fleettrace`` record's
    ``router_ttft_ms == router_wait_ms + redispatch_ms + hedge_wait_ms +
    engine_ttft_ms`` exactly and its ``engine_ttft_ms`` equal to the
    serving replica's own ``reqtrace`` TTFT; prints the time from the
    kill to the first completion rerouted away from replica 1.  None of
    K1-K5 may launch: the counters of this process are zeroed and read
    around (a) and around (b), and each replica reports its own.

26. the divergence guard's rollback (``--nan-guard --ft-rollback-k 2
    --ft-check-every 3 --save-steps 2``) through both trainers.  (a) the LM
    cell (``lm_pretrain``, L 4096, B 4, bf16, f32 weights), 16 steps with
    ``LRSpikeAt`` at step 4: every flagged step leaves the parameters,
    buffers and momentum bitwise as they were, at least one rollback, an
    LR scale under 1, a finite last loss and finite weights, ``skip`` and
    ``rollback`` events in the JSONL; the same spike without the guard must
    end with non-finite weights; then 10 clean steps without and with the
    guard, their median step printed.  (b) ResNet-50 ``--fused-convbn``
    b64 224x224 bf16 through ``tpu_native``, 8 steps, ``NaNBatchAt`` at
    steps 1 (a skip) and 3-4 (a rollback): the poisoned steps leave weights,
    momentum and BN statistics bitwise as they were, one rollback, finite
    at the end.  Each run launches K1-K3 12 times a step (the LM) or K4 33
    and K5 13 times a step (the image net), skipped steps included.  (c)
    ``tools/obs_report.py`` folds (a)'s and (b)'s JSONL: its ``ft`` section
    counts the guards' skips and rollbacks and its goodput books them as
    ``nan_skip`` and ``rollback_discard``; it reports phase 23's LM and
    image files (metrics, heartbeats, telemetry) and prints ``--diff`` of
    the clean LM runs without vs with the guard (no limit).

The line before the last lists each kernel with its launches, error and
times; the last line is the device record.  Needs one CUDA card; exits
non-zero without one.
"""

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticImageDataset
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
from pytorch_distributed_tpu_torch.serving import serve_lm
from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
from pytorch_distributed_tpu_torch.serving.loadgen import LoadConfig, generate_load
from pytorch_distributed_tpu_torch.tools import bench
from pytorch_distributed_tpu_torch.train.checkpoint import (
    CHECKPOINT_NAME,
    load_checkpoint,
    save_checkpoint,
)
from pytorch_distributed_tpu_torch.train import gradsync
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.lm import SyntheticTokenDataset, lm_loss
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils.convert import momentum_state_dict


# K1-K5's wrappers, each counting its launches in ``.launches``.
KERNEL_WRAPPERS = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv,
                   fused_dgrad_wgrad, fused_dgrad_wgrad_3x3)


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


def _conv_bn_bwd_flops(ks, N, H, W, Ci, Co):
    """FLOP of K4 (ks=1) or K5 (ks=3): 2 per multiply-add of dgrad and of
    wgrad over the (pixel, tap) pairs inside the image."""
    pairs = N * (3 * H - 2) * (3 * W - 2) if ks == 3 else N * H * W
    return 4 * pairs * Ci * Co


def _conv_bn_bwd_bound(ks, N, H, W, Ci, Co, bf16):
    """Least time of K4 or K5: their FLOP over the peak; y, do, a and the
    compute-dtype weight read once, the f32 vectors read once, da and the
    f32 dW written once."""
    es = 2 if bf16 else 4
    M = N * H * W
    nbytes = (M * (2 * Co + 2 * Ci) * es + ks * ks * Ci * Co * (es + 4) + 4 * Co * 4)
    return _roofline_ms(_conv_bn_bwd_flops(ks, N, H, W, Ci, Co), nbytes, bf16)


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


def _instrument(eng):
    """Time an engine's work as it runs: host wall time of every decode
    iteration and prefill, and CUDA events around every decode-step
    replay (the device time of the step)."""
    rec = dict(decode_s=[], replay_events=[], prefill_s=0.0, chunks=0)
    decode, replay, prefill = eng._decode, eng._run_decode_step, eng._prefill

    def timed_decode(live):
        t0 = time.perf_counter()
        n = decode(live)
        rec["decode_s"].append(time.perf_counter() - t0)
        return n

    def timed_replay():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay()
        b.record()
        rec["replay_events"].append((a, b))

    def timed_prefill(slot, req):
        t0 = time.perf_counter()
        prefill(slot, req)
        rec["prefill_s"] += time.perf_counter() - t0
        rec["chunks"] += -(-len(req.prompt) // eng.chunk_size)

    eng._decode, eng._run_decode_step, eng._prefill = timed_decode, timed_replay, timed_prefill
    return rec


def _top2_gaps(logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).tolist()


def serving_engine_phase(dev, card, lm, kv_blocks=385, n_requests=64, n_dense=8,
                         entry_requests=16):
    """Phase 12: the paged continuous-batching engine at the width ``lm``."""
    kernels = KERNEL_WRAPPERS
    for k in kernels:
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm_params(**lm, seed=0, device=dev)
    eng_cfg = dict(lm, max_batch=16, kv_blocks=kv_blocks, block_size=16, blocks_per_seq=64,
                   chunk_size=128, max_new_tokens=384, policy="fcfs",
                   defrag_threshold_pct=50.0, device=dev)
    load_cfg = LoadConfig(n_requests=n_requests, rate_rps=200.0, profile="mixed",
                          vocab_size=lm["vocab_size"], prompt_min=128, prompt_max=512,
                          short_min=16, short_max=64, long_min=256, long_max=384,
                          long_frac=0.2, seed=0)
    tokens, prompts = {}, {}
    for mode in ("continuous", "static"):
        eng = ServingEngine(params, mode=mode, **eng_cfg)
        rec = _instrument(eng)
        load = generate_load(load_cfg)
        prompts = {r.rid: list(r.prompt) for _, r in load}
        s = eng.run(load)
        torch.cuda.synchronize()
        tokens[mode] = {r.rid: list(r.generated) for r in eng.finished}
        replay_ms = [a.elapsed_time(b) for a, b in rec["replay_events"]]
        wall_ms = [t * 1e3 for t in rec["decode_s"]]
        busy = sum(replay_ms) / sum(wall_ms)
        print(f"[engine] {mode}: {s['completed']}/{n_requests} requests, {s['tokens']} tokens "
              f"in {s['wall_s']} s, {s['tokens_per_s']} tokens/s; TTFT p50 {s['ttft_p50_ms']} "
              f"p99 {s['ttft_p99_ms']} ms; ITL p50 {s['itl_p50_ms']} p99 {s['itl_p99_ms']} ms; "
              f"{eng.decode_iterations} decode iterations in {s['steps']} steps, decode step "
              f"wall median {statistics.median(wall_ms)} ms, graph replay device median "
              f"{statistics.median(replay_ms)} ms, device busy {100 * busy}% of decode wall; "
              f"prefill {1e3 * rec['prefill_s'] / rec['chunks']} ms per {eng.chunk_size}-token "
              f"chunk ({rec['chunks']} chunks); preemptions {s['preemptions']}, defrags "
              f"{s['defrags']}, alloc failures {s['alloc_failures']}; graph captures "
              f"{eng.graph_captures}, replays {eng.graph_replays}; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30} GiB; card {card}")
        if s["completed"] != n_requests:
            raise SystemExit(f"{mode} engine completed {s['completed']} of {n_requests}")
        if eng.graph_captures != 1 or eng.graph_replays != eng.decode_iterations:
            raise SystemExit(f"{mode} engine captured its decode graph {eng.graph_captures} "
                             f"times and replayed it {eng.graph_replays} times in "
                             f"{eng.decode_iterations} decode iterations")
        if mode == "continuous" and s["preemptions"] < 1:
            raise SystemExit(f"the trace did not preempt with {kv_blocks} KV blocks")
        del eng, rec
        gc.collect()   # the timing wrappers hold the engine in a cycle
        torch.cuda.empty_cache()

    # Greedy tokens: static against continuous, then the first requests
    # against the dense KV-cache path, each up to the dense path's first
    # top-2 logit gap under 1e-3 (the two attentions reduce over windows of
    # different length, so f32 order may differ).
    dense = TransformerLM(**lm, dtype=torch.float32, device=dev, attn_impl="dense")
    dense.load_state_dict(params)
    del params

    def gaps_of(rid, toks):
        seq = torch.tensor([prompts[rid] + toks], device=dev)
        with torch.no_grad():
            logits = dense(seq)[0, len(prompts[rid]) - 1:-1]
        return _top2_gaps(logits)

    for rid, want in tokens["continuous"].items():
        got = tokens["static"][rid]
        if got != want:
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            gap = gaps_of(rid, want)[j]
            print(f"[engine] static and continuous differ for rid {rid} at token {j}; "
                  f"top-2 logit gap there {gap}")
            if not gap < 1e-3:
                raise SystemExit("static and continuous modes emit different tokens")
    # Against the dense path: identical up to the first differing token,
    # and that token sits where the dense top-2 gap is under 1e-3 (the
    # tokens before it are the same, so the dense logits there hold for
    # both).  Also counted: the tokens before each request's first gap
    # under 1e-3, compared or not.
    compared = before_gap = total = 0
    for rid in range(n_dense):
        got = tokens["continuous"][rid]
        want = greedy_generate(dense, torch.tensor([prompts[rid]], device=dev), len(got),
                               flash_prefill=False)[0].tolist()
        gaps = gaps_of(rid, want)
        diff = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
        if diff < len(want) and not gaps[diff] < 1e-3:
            raise SystemExit(f"engine and dense path disagree for rid {rid} at token {diff}, "
                             f"where the dense top-2 logit gap is {gaps[diff]}")
        compared += diff
        before_gap += next((j for j, g in enumerate(gaps) if g < 1e-3), len(want))
        total += len(want)
    print(f"[engine] first {n_dense} requests against the dense path: {compared} of {total} "
          f"tokens identical before the first difference, which (if any) sits at a top-2 "
          f"gap under 1e-3; {before_gap} of {total} before each request's first gap under "
          f"1e-3")
    if compared < 0.9 * total:
        raise SystemExit(f"only {compared} of {total} tokens compared with the dense path")
    del dense
    torch.cuda.empty_cache()

    os.makedirs("build", exist_ok=True)
    summary_path = "build/serve_lm_smoke.json"
    rc = serve_lm.main([
        "--vocab-size", str(lm["vocab_size"]), "--d-model", str(lm["d_model"]),
        "--n-heads", str(lm["n_heads"]), "--n-layers", str(lm["n_layers"]),
        "--max-batch", "16", "--kv-blocks", str(kv_blocks), "--block-size", "16",
        "--blocks-per-seq", "64", "--chunk-size", "128", "--max-new-tokens", "384",
        "--requests", str(entry_requests), "--summary-json", summary_path, "--device", str(dev)])
    with open(summary_path) as f:
        completed = json.load(f)["completed"]
    print(f"[engine] serve_lm.main: rc {rc}, {completed}/{entry_requests} requests completed")
    if rc != 0 or completed != entry_requests:
        raise SystemExit(f"serve_lm returned {rc} with {completed} of {entry_requests} completed")
    launched = [k.launches for k in kernels]
    print(f"[engine] kernel launches K1-K5 during phase 12: {launched}")
    if any(launched):
        raise SystemExit("the serving engine launched a kernel it should not reach")
    torch.cuda.empty_cache()


def _state(model, optimizer):
    """Clones of the weights, buffers and SGD momentum of a trained model."""
    out = {k: t.detach().clone() for k, t in model.state_dict().items()}
    out.update({f"momentum:{k}": t.detach().clone()
                for k, t in momentum_state_dict(model, optimizer).items()})
    return out


def _same_run(tag, losses, want_losses, state, want_state):
    """Hold a resumed run against the uninterrupted one: bitwise equality is
    expected; anything worse than tests/test_ft.py's resume tolerance (loss
    rel 1e-6, weights rtol 1e-6 / atol 1e-7) fails."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    errs = {k: (t.float() - want_state[k].float()).abs().max().item() for k, t in state.items()}
    worst = max(errs, key=errs.get)
    bitwise = losses == want_losses and all(torch.equal(t, want_state[k])
                                            for k, t in state.items())
    close = all(torch.allclose(t.float(), want_state[k].float(), rtol=1e-6, atol=1e-7)
                for k, t in state.items())
    print(f"[checkpoint] {tag}: resumed losses {losses} vs uninterrupted {want_losses} (max rel "
          f"err {loss_err}); {len(state)} weight, buffer and momentum tensors, worst "
          f"{worst} max abs err {errs[worst]}; bitwise equal: {bitwise}")
    if len(losses) != len(want_losses) or loss_err > 1e-6 or not close:
        raise SystemExit(f"{tag}: the resumed run does not end where the uninterrupted one "
                         f"does (worst tensor {worst})")


def _tokens_of(main, argv):
    """Run a recipe's ``main(argv)`` and read its ``tokens: [...]`` line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    sys.stdout.write(text)
    m = re.search(r"^tokens: (\[.*\])$", text, re.M)
    if rc != 0 or m is None:
        raise SystemExit(f"{main.__module__} returned {rc} with no tokens line")
    return json.loads(m.group(1))


def checkpoint_phase(dev, card, cfg, prompt_tokens):
    """Phase 13: save and resume at full width (LM and ResNet-50), then
    sample and serve from the LM's file.  Returns the kernel launches of
    the resumed runs: (K1, K2, K3, K4, K5)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        return _checkpoint_phase(dev, card, cfg, prompt_tokens, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _checkpoint_phase(dev, card, cfg, prompt_tokens, tmp):
    L = cfg["n_layers"]
    lm = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]), "--n-heads",
          str(cfg["n_heads"]), "--n-layers", str(L), "--seq-len", "4096", "-b", "4",
          "--precision", "bf16", "-p", "1", "--no-eval", "--device", "cuda"]
    # (a) 6 steps uninterrupted; 4 steps saving every 2; resume to step 6.
    ref = lm_pretrain.run(lm + ["--steps", "6"])
    want_losses, want = [float(x) for x in ref.losses], _state(ref.model, ref.optimizer)
    del ref
    torch.cuda.empty_cache()
    d = os.path.join(tmp, "lm")
    first = lm_pretrain.run(lm + ["--steps", "4", "--save-steps", "2", "--checkpoint-dir", d])
    first_losses = [float(x) for x in first.losses]
    del first
    torch.cuda.empty_cache()
    path = os.path.join(d, CHECKPOINT_NAME)
    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    resumed = lm_pretrain.run(lm + ["--steps", "6", "--resume", path, "--checkpoint-dir", d])
    torch.cuda.synchronize()
    lm_launches = (flash_attention.launches, flash_attention_bwd_dq.launches,
                   flash_attention_bwd_dkv.launches)
    print(f"[checkpoint] LM resume from step {resumed._start_step}: launches K1/K2/K3 "
          f"{lm_launches} over {len(resumed.losses)} steps")
    if lm_launches != (2 * L,) * 3 or resumed._start_step != 4:
        raise SystemExit(f"the resumed LM run launched (K1, K2, K3) {lm_launches} times "
                         f"from step {resumed._start_step}, expected {(2 * L,) * 3} from 4")
    _same_run("LM 183.9M, L=4096 B=4 bf16", first_losses + [float(x) for x in resumed.losses],
              want_losses, _state(resumed.model, resumed.optimizer), want)
    del want
    # The file's size and the save and load times, at full width.
    d2 = os.path.join(tmp, "timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = save_checkpoint(d2, resumed.model, resumed.optimizer, 6, 0, "transformer_lm", 0.0,
                            False, ft={"step": 6, "global_step": 6})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, _ = load_checkpoint(timed, resumed.model, resumed.optimizer)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[checkpoint] LM file {os.path.getsize(timed)} bytes (params and momentum, "
          f"{sum(p.numel() for p in resumed.model.parameters())} parameters): save "
          f"{t_save} s, load {t_load} s (step {step}); card {card}")

    # (b) lm_generate --resume on the resumed run's final file, against the
    # same weights in memory.
    n_new = 8
    gen_args = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
                "--n-heads", str(cfg["n_heads"]), "--n-layers", str(L), "--precision", "bf16",
                "--prompt-tokens", prompt_tokens, "-n", str(n_new), "--device", "cuda"]
    flash_attention.launches = 0
    got = _tokens_of(lm_generate.main, gen_args + ["--resume", path])
    torch.cuda.synchronize()
    gen_launches = flash_attention.launches
    mem = TransformerLM(**cfg, dtype=torch.bfloat16, device=dev)
    mem.load_state_dict(resumed.model.state_dict())
    del resumed
    flash_attention.launches = 0   # the in-memory reference's prefill is not counted
    prompt = torch.tensor([[int(t) for t in prompt_tokens.split(",")]], device=dev)
    ref_tokens = generate(mem, prompt, n_new)[0].tolist()
    flash_attention.launches = 0
    del mem
    torch.cuda.empty_cache()
    print(f"[checkpoint] lm_generate --resume: tokens {got}, in-memory weights {ref_tokens}; "
          f"K1 launches {gen_launches}")
    if got != ref_tokens or gen_launches != L:
        raise SystemExit("lm_generate --resume disagrees with the trained weights or did not "
                         "prefill through K1 once per layer")

    # (c) serve_lm --checkpoint on the same file.
    summary_path = os.path.join(tmp, "serve.json")
    rc = serve_lm.main(["--checkpoint", path, "--n-heads", str(cfg["n_heads"]),
                        "--max-batch", "16", "--kv-blocks", "385", "--block-size", "16",
                        "--blocks-per-seq", "64", "--chunk-size", "128",
                        "--max-new-tokens", "384", "--requests", "16",
                        "--summary-json", summary_path, "--device", "cuda"])
    with open(summary_path) as f:
        completed = json.load(f)["completed"]
    print(f"[checkpoint] serve_lm --checkpoint: rc {rc}, {completed}/16 requests completed")
    if rc != 0 or completed != 16:
        raise SystemExit(f"serve_lm --checkpoint returned {rc} with {completed} of 16 completed")
    torch.cuda.empty_cache()

    # (d) ResNet-50 resumed mid-epoch: a 4-step epoch stopped by the
    # trainer's own API after step 2, where --save-steps 2 saved, then
    # resumed.  cuDNN runs its deterministic algorithms here (the stride-2
    # and stem convolutions' backward), so two runs can be equal bitwise.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        img = ["-a", "resnet50", "--synthetic", "--fused-convbn", "-b", "256",
               "--image-size", "224", "--synthetic-length", "1024", "--epochs", "1",
               "--precision", "bf16", "--seed", "0", "-p", "1", "--device", "cuda"]
        ref = Trainer(parse_config(img + ["--checkpoint-dir", os.path.join(tmp, "img_ref")]))
        ref.fit()
        want_losses, want = [float(x) for x in ref.losses], _state(ref.model, ref.optimizer)
        del ref
        torch.cuda.empty_cache()
        d = os.path.join(tmp, "img")
        first = Trainer(parse_config(img + ["--checkpoint-dir", d, "--save-steps", "2"]))
        if first.train_epoch(0, stop_after=2) != 2:
            raise SystemExit("the image trainer did not stop after step 2")
        first_losses = [float(x) for x in first.losses]
        del first
        torch.cuda.empty_cache()
        path = os.path.join(d, CHECKPOINT_NAME)
        size = os.path.getsize(path)
        fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
        resumed = Trainer(parse_config(img + ["--checkpoint-dir", d, "--resume", path]))
        resumed.fit()
        torch.cuda.synchronize()
        img_launches = (fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches)
        print(f"[checkpoint] ResNet-50 resume at epoch 0 step {resumed._resume_step} from a "
              f"{size}-byte file: launches K4/K5 {img_launches} over {len(resumed.losses)} "
              f"steps and 1 eval batch")
        if img_launches != (2 * 33, 2 * 13) or len(resumed.losses) != 2:
            raise SystemExit(f"the resumed image run launched (K4, K5) {img_launches} times in "
                             f"{len(resumed.losses)} steps, expected (66, 26) in 2")
        _same_run("ResNet-50 --fused-convbn b256 bf16", first_losses
                  + [float(x) for x in resumed.losses], want_losses,
                  _state(resumed.model, resumed.optimizer), want)
        del resumed, want
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    return lm_launches + (gen_launches,) + img_launches


def bench_phase(card):
    """Phase 14: the bench.py twin's JSON line, tagged."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise SystemExit(f"tools.bench returned {rc} with output {lines}")
    rec = json.loads(lines[0])
    print(f"[bench] {lines[0]}")
    if not rec["value"] > 0:
        raise SystemExit(f"tools.bench measured {rec['value']}")
    torch.cuda.empty_cache()


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "images")


def _link_tree(root, sources, n_train, n_val, classes):
    """An ImageFolder tree under ``root``: ``classes`` class directories in
    train/ and val/, image i of a split in class i % classes, linked to
    ``sources[i % len(sources)]`` (hard links where the filesystem allows,
    else symbolic ones)."""
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            os.makedirs(os.path.join(root, split, f"n{c:08d}"))
        for i in range(n):
            src = sources[i % len(sources)]
            dst = os.path.join(root, split, f"n{i % classes:08d}",
                               f"{i:05d}_{os.path.basename(src)}")
            try:
                os.link(src, dst)
            except OSError:
                os.symlink(src, dst)


def _fed(trainer, host):
    """``host`` through the trainer's own feeder: the batch as it lands."""
    (batch,) = list(trainer.feeder(iter([host])))
    return batch


def data_phase(dev, card, arch="resnet50", batch=256, image_size=224, classes=1000,
               n_train=1280, n_val=204, per_step=(33, 13), require_jpeg=True):
    """Phase 15: ``tpu_native --data`` on an ImageFolder tree linked from the
    committed fixtures, once per ``--wire``.  Returns the (K4, K5) launches
    of its train steps."""
    from pytorch_distributed_tpu_torch.data import imageio, native
    from pytorch_distributed_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    nproc = os.cpu_count()
    jpeg = native.jpeg_native_available()
    libs = native.resolve_libraries()
    files = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
                   if f.endswith((".JPEG", ".png")))
    sources = files if jpeg else [f for f in files if f.endswith(".png")]
    print(f"[data] the C++ plane links libjpeg {libs['jpeg']} and libwebp {libs['webp']}; "
          + ("" if jpeg else "--wire native did not run; the f32, u8host and u8 runs use "
             "the PNG twins; ") + f"{len(sources)} source files; nproc {nproc}; card {card}")
    if require_jpeg and not jpeg:
        raise SystemExit("no libjpeg.so.62 on this host: " + native.binding.searched("jpeg"))
    # Decoding is deterministic, and its cost per file on this host.
    for f in files if jpeg else sources:
        first = imageio.read_image(f)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = imageio.read_image(f)
            times.append((time.perf_counter() - t0) * 1e3)
        if not (first.dtype == again.dtype and (first == again).all()):
            raise SystemExit(f"decoding {f} twice gave different pixels")
        print(f"[data] decode {os.path.basename(f)} {first.shape[1]}x{first.shape[0]}: median "
              f"{statistics.median(times)} ms of 5, same pixels twice; card {card}")
    img = imageio.read_image(next(f for f in sources if "rgb0" in f))
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        native.resize_bilinear(img, (image_size, image_size))
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[data] resize {img.shape[1]}x{img.shape[0]} -> {image_size}x{image_size} (PIL's "
          f"bilinear): median {statistics.median(times)} ms of 20; nproc {nproc}; card {card}")

    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    ckpt_dir = os.path.join(root, "ckpt")
    runs, launches = {}, [0, 0]
    steps = n_train // batch
    try:
        t0 = time.perf_counter()
        _link_tree(os.path.join(root, "data"), sources, n_train, n_val, classes)
        print(f"[data] tree: {classes} classes, {n_train} train and {n_val} val images linked "
              f"in {time.perf_counter() - t0} s")
        modes = [("f32", "thread"), ("u8host", "thread"), ("u8", "process")]
        if jpeg:
            modes.append(("native", "thread"))
        for wire, worker in modes:
            fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
            t0 = time.perf_counter()
            trainer = tpu_native.run([
                "--data", os.path.join(root, "data"), "-a", arch, "--fused-convbn", "-b",
                str(batch), "--image-size", str(image_size), "--wire", wire,
                "--worker-type", worker, "-j", str(nproc), "--epochs", "1", "--precision",
                "bf16", "--seed", "0", "-p", "10", "--epoch-csv",
                os.path.join(root, "epochs.csv"), "--checkpoint-dir", ckpt_dir,
                "--device", str(dev)])
            run_s = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.synchronize()
            got = (fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches)
            want = (per_step[0] * steps, per_step[1] * steps)
            losses = [float(x) for x in trainer.losses]
            eval_loss = trainer.eval_history[0][0]
            if got != want or len(losses) != steps:
                raise SystemExit(f"--wire {wire}: (K4, K5) launched {got} times in "
                                 f"{len(losses)} steps and one eval batch, expected {want}")
            if not all(math.isfinite(x) for x in losses + [eval_loss]):
                raise SystemExit(f"--wire {wire}: non-finite loss {losses}, eval {eval_loss}")
            launches[0] += got[0]
            launches[1] += got[1]
            fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
            trainer.validate()
            if (fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches) != (0, 0):
                raise SystemExit(f"--wire {wire}: eval launched K4 or K5")
            wait_per_batch = trainer.feeder.wait_s / (steps + 2 * len(trainer.val_loader))
            # The loader alone: one more epoch of host batches, nothing fed.
            t0 = time.perf_counter()
            host = list(trainer.train_loader)
            loader_ips = len(host) * batch / (time.perf_counter() - t0)
            nbytes = sum(v.nbytes for v in host[0].values())
            trainer.train_loader.set_epoch(0)
            with contextlib.closing(trainer.train_loader.iter_batches(0)) as it:
                host_train = next(it)
            with contextlib.closing(trainer.val_loader.iter_batches(0)) as it:
                host_val = next(it)
            runs[wire] = dict(
                train=_fed(trainer, host_train)["images"], host_train=host_train,
                val=_fed(trainer, host_val)["images"], val_weights=host_val["weights"],
                val_names=[os.path.basename(trainer.val_set.samples[i][0])
                           for i in range(min(batch, len(trainer.val_set)))])
            step_ms = statistics.median(trainer.step_times[1:]) * 1e3
            print(f"[data] --wire {wire} --worker-type {worker} -j {nproc}: host "
                  f"{loader_ips} images/s (loader alone, {len(host)} batches of {batch}); "
                  f"step {step_ms} ms (median of steps 2-{steps}; all "
                  f"{[t * 1e3 for t in trainer.step_times]}); feeder wait "
                  f"{wait_per_batch} s per batch ({trainer.feeder.wait_s} s over {steps} "
                  f"train and {2 * len(trainer.val_loader)} eval batches); {nbytes} bytes "
                  f"copied per batch ({host[0]['images'].dtype} images); losses {losses}; "
                  f"eval loss {eval_loss}; run {run_s} s; launches K4/K5 {got}; "
                  f"nproc {nproc}; card {card}")
            trainer.train_loader.close()
            trainer.val_loader.close()
            del trainer, host
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # The first batches on the card.  Eval is deterministic: f32, u8host
    # and u8 must agree to 1e-5 (normalized where each mode normalizes:
    # per sample on the host, per batch in C++, on the card).  Train: u8host
    # and u8 share crops and the batch flip stream; u8's uint8 batch must be
    # the unflipped batch mirrored where the JAX stream (seed, epoch, batch,
    # 1) says; f32 draws its flip per sample, so each f32 image must equal
    # the unflipped u8 image or its mirror.
    ref = runs["f32"]
    live = torch.from_numpy(ref["val_weights"]).to(dev) > 0
    for wire in ("u8host", "u8"):
        # Padding slots (weight 0) differ by design: f32 pads with 0.0, the
        # uint8 modes pad with 0 and normalize it.
        same_mask = (runs[wire]["val_weights"] == ref["val_weights"]).all()
        err = (runs[wire]["val"] - ref["val"])[live].abs().max().item()
        print(f"[data] first eval batch on the card, --wire {wire} vs f32: max abs err {err} "
              f"over its {int(live.sum())} live slots; same weights: {same_mask}")
        if not (err <= 1e-5 and same_mask):
            raise SystemExit(f"--wire {wire}: its first eval batch differs from f32's by {err}")
    err = (runs["u8host"]["train"] - runs["u8"]["train"]).abs().max().item()
    flip = np.random.default_rng((0, 0, 0, 1)).random(batch) < 0.5
    u8 = runs["u8"]["host_train"]["images"]
    unflipped = u8.copy()
    unflipped[flip] = u8[flip, :, ::-1]
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    plain = (torch.from_numpy(unflipped).to(dev).float() / 255.0 - mean) / std
    same = (ref["train"] - plain).flatten(1).abs().amax(1)
    mirrored = (ref["train"] - plain.flip(2)).flatten(1).abs().amax(1)
    best = torch.minimum(same, mirrored)
    print(f"[data] first train batch: u8host vs u8 max abs err {err}; u8's flips follow the "
          f"(seed, epoch, batch, 1) stream ({int(flip.sum())} of {batch} mirrored); f32 vs "
          f"the unflipped u8 crop or its mirror: max abs err {best.max().item()} "
          f"({int((same <= mirrored).sum())} unmirrored, {int((same > mirrored).sum())} "
          "mirrored)")
    if not (err <= 1e-5 and best.max().item() <= 1e-5):
        raise SystemExit("the first train batches of the wire modes disagree")
    if "native" in runs:
        # The JAX package's native plane crops and resizes by its own
        # bilinear after an IFAST decode (a documented delta), so it is held
        # to the JAX test's bound against the PIL-exact u8 eval batch: mean
        # |difference| under 4 of 255, over the slots it decoded.
        nat = runs["native"]
        live = torch.from_numpy(nat["val_weights"]).to(dev) > 0
        diff = ((nat["val"] - runs["u8"]["val"]) * std * 255.0)[live].abs()
        dead = [n for n, w in zip(nat["val_names"], nat["val_weights"]) if w == 0]
        expect = [n for n in nat["val_names"] if "cmyk6" in n or "png7" in n]
        print(f"[data] --wire native first eval batch vs u8 (PIL-exact): mean abs diff "
              f"{diff.mean().item()} of 255, max {diff.max().item()}; {len(dead)} slots "
              "masked (libjpeg-turbo refuses CMYK to RGB; a PNG named .JPEG is no JPEG)")
        if not (diff.mean().item() < 4.0 and dead == expect):
            raise SystemExit("--wire native: its eval batch or its masked slots are wrong")
    return launches



# Phase 16: the data-parallel recipes, each through its launcher contract.
# A recipe runs in a fresh process: ``python3 chip_smoke.py --recipe-worker
# NAME OUT [--tf32-off] [--time] [--layer-check] [--per-rank-bn]
# [--local-k45-vectors] [--no-grad-sum] [--scale-images=F] -- ARGS`` runs
# ``recipes.NAME.main(ARGS)``
# with the launch counters zeroed just before and read just after, then
# writes what the parent checks to OUT/result.json and the final weights
# to OUT/state.pt.
# World 2 against world 1 (f32, TF32 off, 3 steps): the limits lie between
# the sound run's readings and its controls' (PERF.md, phase 16).
# int8 generate in bf16 against the dequantized weights in bf16: the two
# round at other points (x @ w_q then * scale, against x @ (w_q * scale)), so
# their logits differ by bf16 noise, measured up to 0.0625 on the last
# prefill position (two bf16 ulps of a logit in [4, 8); f32: 9.1e-6); a
# greedy token may flip only where the reference's top-2 gap is below twice
# that.
INT8_BF16_GAP = 0.125
WORLD_LOSS_REL = 7e-7
WORLD_WEIGHT_ABS = 3.5e-4
WORLD_LAYER = 1e-4
DP_RECIPES = ("distributed", "apex_distributed", "multiprocessing_distributed",
              "dataparallel", "horovod_distributed", "distributed_slurm_main", "tpu_native")


def recipe_worker(argv) -> int:
    import importlib

    import torch.distributed as tdist

    name, out = argv[0], argv[1]
    flags = argv[2:argv.index("--")]
    args = argv[argv.index("--") + 1:]
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if "--tf32-off" in flags:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # Controls of the world-invariance checks, each a fault they must see.
    if "--per-rank-bn" in flags:  # plain DDP: every BatchNorm over this rank's batch
        from pytorch_distributed_tpu_torch.models import layers, resnet

        resnet.ResNet.set_bn_group = lambda self, group: self
        layers.ImageModel.set_bn_group = lambda self, group: self
    if "--no-grad-sum" in flags:  # DDP's hook hands back this rank's gradient unsummed
        from pytorch_distributed_tpu_torch.train import steps as steps_lib

        def unsummed(group, bucket):
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer())
            return fut

        steps_lib._sum_hook = unsummed
    scale = next((float(f.split("=", 1)[1]) for f in flags if f.startswith("--scale-images=")),
                 None)
    if scale is not None:  # the chaos probe: every train step sees images x scale
        from pytorch_distributed_tpu_torch.train import trainer as trainer_lib

        make_step = trainer_lib.make_train_step

        def scaled_step(*a, **kw):
            inner = make_step(*a, **kw)

            def step(batch, lr):
                return inner({**batch, "images": batch["images"] * scale}, lr)

            step.comm = inner.comm
            return step

        trainer_lib.make_train_step = scaled_step
    if "--local-k45-vectors" in flags:  # K4/K5's t, u from this rank's sums only
        from pytorch_distributed_tpu_torch.ops import fused_conv_bn

        fused_conv_bn.global_sums = lambda dbeta, dgamma, n, group: (dbeta, dgamma, n)
    mod = importlib.import_module(f"pytorch_distributed_tpu_torch.recipes.{name}")
    trainers = []
    mod.finish = lambda t: trainers.append(t) or t.best_acc1  # keep the group up
    fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
    t0 = time.perf_counter()
    mod.main(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = [fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches]
    (trainer,) = trainers
    ctx = trainer.ctx
    res = {"recipe": name, "backend": ctx.backend, "world": ctx.process_count,
           "rank": ctx.process_index, "device": str(trainer.device),
           "launches": launches, "steps": len(trainer.losses), "run_s": run_s,
           "losses": [float(x) for x in trainer.losses],
           "eval": list(trainer.eval_history[0]), "precision": trainer.cfg.precision,
           "explicit": trainer.explicit_collectives, "wire": trainer.cfg.grad_compress,
           "step_times_ms": [t * 1e3 for t in trainer.step_times],
           "param_bytes": 4 * sum(p.numel() for p in trainer.model.parameters()),
           "n_params": len(list(trainer.model.parameters())),
           "momentum_bytes": gradsync.momentum_bytes(trainer.optimizer, trainer.comm),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if torch.cuda.is_available() else 0.0)}
    if ctx.process_index == 0:
        torch.save({k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
                   os.path.join(out, "state.pt"))
    if "--time" in flags:
        # The train step alone on one device batch (the host's synthetic
        # batches take longer than a step): 2 warm-up steps, median of 7.
        dev = trainer.device
        g = torch.Generator(device=dev).manual_seed(1)
        b = trainer.local_batch
        side, classes = trainer.cfg.image_size, trainer.cfg.num_classes
        batch = {"images": torch.randn(b, side, side, 3, device=dev, generator=g),
                 "labels": torch.randint(0, classes, (b,), device=dev, generator=g),
                 "weights": torch.ones(b, device=dev)}
        times = []
        for _ in range(9):
            t0 = time.perf_counter()
            trainer.train_step(batch, 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["step_ms"] = statistics.median(times[2:])
        res["step_ms_all"] = times
        if ctx.group is not None:
            # One all-reduce of ResNet-50's f32 gradients as one flat buffer.
            n = sum(p.numel() for p in trainer.model.parameters())
            flat = torch.ones(n, device=dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ms = []
            for i in range(12):
                ev[0].record()
                tdist.all_reduce(flat, group=ctx.group)
                ev[1].record()
                torch.cuda.synchronize()
                if i >= 2:
                    ms.append(ev[0].elapsed_time(ev[1]))
            res["allreduce_ms"] = statistics.median(ms)
            res["allreduce_bytes"] = 4 * n
    if "--layer-check" in flags:
        res["layer_err"] = layer_check(ctx, trainer.device)
    with open(os.path.join(out, f"result{ctx.process_index}.json"), "w") as f:
        json.dump(res, f)
    from pytorch_distributed_tpu_torch.parallel import shutdown
    shutdown(ctx)
    return 0


def layer_check(ctx, dev, n=256) -> dict:
    """K4's and K5's layers under ``ctx``'s group against the same layer on
    the whole batch without one, at ResNet-50's stage-1 shapes (256->64 1x1
    and 64->64 3x3 at 56x56, relu, seeded inputs, f32): this rank's rows of
    da and the ranks' summed dW, dgamma and dbeta.  Returns
    ``{kernel: largest |difference| / largest |reference|}``."""
    import torch.distributed as tdist

    from pytorch_distributed_tpu_torch.ops.fused_conv_bn import conv1x1_bn_act, conv3x3_bn_act

    world, rank = ctx.process_count, ctx.process_index
    rows = slice(rank * n // world, (rank + 1) * n // world)
    g = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    for name, op, ks, ci, co in (("K4", conv1x1_bn_act, 1, 256, 64),
                                 ("K5", conv3x3_bn_act, 3, 64, 64)):
        a = torch.randn(n, 56, 56, ci, device=dev, generator=g)
        do = torch.randn(n, 56, 56, co, device=dev, generator=g)
        params = (torch.randn(co, ci, ks, ks, device=dev, generator=g) / (ci * ks * ks) ** 0.5,
                  1 + 0.1 * torch.randn(co, device=dev, generator=g),
                  0.1 * torch.randn(co, device=dev, generator=g))

        def grads(a_, do_, group):
            leaves = [a_.clone().requires_grad_()] + [t.clone().requires_grad_() for t in params]
            o, _, _ = op(*leaves, 1e-5, True, group)
            o.backward(do_)
            return [t.grad for t in leaves]

        want = grads(a, do, None)
        want[0] = want[0][rows]
        got = grads(a[rows], do[rows], ctx.group)
        for t in got[1:]:
            tdist.all_reduce(t, group=ctx.group)
        errs[name] = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want))
        del a, do, want, got
    return errs


_PORTS_GIVEN: set = set()


def _free_port() -> int:
    """A free TCP port on 127.0.0.1 for a rendezvous store, drawn below
    Linux's default ephemeral range (32768-60999), and never the same one
    twice in this process.  A port from ``bind(0)`` lies inside that range,
    where NCCL's and gloo's listeners and every outgoing connection of the
    workers started meanwhile can take it before the store binds it
    (EADDRINUSE)."""
    import random
    import socket

    rng = random.Random()  # seeded from the OS: each process draws its own
    for _ in range(1000):
        port = rng.randrange(20000, 32768)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
    raise RuntimeError("no free TCP port in 20000-32767")


def _clean_env(env=None) -> dict:
    """This process's environment without any launcher's variables, this
    script's directory on the path, plus ``env``."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PTD_TPU", "SLURM_", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                                 "LOCAL_WORLD_SIZE", "MASTER_", "TORCHELASTIC", "GROUP_"))}
    here = os.path.dirname(os.path.abspath(__file__))
    base["PYTHONPATH"] = here + os.pathsep + base.get("PYTHONPATH", "")
    base.update(env or {})
    return base


def _launch(name, out, args, flags=(), env=None, torchrun=False):
    """Start one recipe worker (``env`` added to a clean environment);
    returns the Popen."""
    os.makedirs(out, exist_ok=True)
    base = _clean_env(env)
    here = os.path.dirname(os.path.abspath(__file__))
    me = [os.path.join(here, "chip_smoke.py"), "--recipe-worker", name, out, *flags, "--",
          *args]
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
            f"--master_port={_free_port()}", *me] if torchrun else [sys.executable, *me])
    return subprocess.Popen(cmd, env=base, cwd=out, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, what, timeout=600):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"{what} exited {p.returncode}:\n{log[-4000:]}")
    return outs


def dp_args(steps=3, batch=256):
    """Phase 16's recipe flags: ResNet-50 ``--fused-convbn``, synthetic
    224x224, ``steps`` steps of ``batch``."""
    return ["-a", "resnet50", "--synthetic", "--fused-convbn", "-b", str(batch),
            "--image-size", "224", "--synthetic-length", str(steps * batch), "--epochs", "1",
            "--seed", "0", "-p", "1", "-j", "4"]


def dp_phase(card, steps=3, batch=256, small=64, per_step=(33, 13)):
    """Phase 16: the six data-parallel recipes and ``tpu_native`` at world 1
    (NCCL where a launcher names the world), bitwise ``distributed`` vs the
    launcher-less ``tpu_native``, world 2 on the one card over gloo vs world
    1 (f32, TF32 off), DDP's step and all-reduce times.  The two timed
    recipes train b``batch``; the untimed ones and the world-invariance and
    ``--sync-bn`` checks b``small``, so each set fits the card at once.
    Returns the (K4, K5) launches of the world-1 recipe runs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    launches, results = [0, 0], {}
    try:
        # The two timed recipes run alone; the other five together on the
        # card (their launch counts and results are per process).
        for group in (("distributed",), ("tpu_native",),
                      ("apex_distributed", "multiprocessing_distributed", "dataparallel",
                       "horovod_distributed", "distributed_slurm_main")):
            procs, t0 = [], time.perf_counter()
            common = dp_args(steps, batch if len(group) == 1 else small)
            for name in group:
                out = os.path.join(root, name)
                args = common + ["--checkpoint-dir", os.path.join(out, "ckpt"),
                                 "--epoch-csv", os.path.join(out, "epochs.csv")]
                if name in ("distributed", "tpu_native"):
                    args += ["--precision", "bf16"]  # the same run: the bitwise check
                env, torchrun = {}, name in ("distributed", "apex_distributed")
                if name in ("multiprocessing_distributed", "dataparallel"):
                    # Their own launcher, on a free port in place of 23456.
                    env = {"PTD_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}"}
                elif name == "horovod_distributed":
                    env = {"PTD_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                           "PTD_TPU_NUM_PROCESSES": "1", "PTD_TPU_PROCESS_ID": "0"}
                elif name == "distributed_slurm_main":
                    env = {"SLURM_PROCID": "0", "SLURM_NTASKS": "1",
                           "PTD_TPU_PORT": str(_free_port())}
                flags = ("--time",) if name in ("distributed", "tpu_native") else ()
                procs.append(_launch(name, out, args, flags, env, torchrun))
            logs = _wait(procs, " + ".join(group))
            for name, log in zip(group, logs):
                with open(os.path.join(root, name, "result0.json")) as f:
                    res = json.load(f)
                res["wall_s"] = time.perf_counter() - t0
                results[name] = res
                want = [per_step[0] * steps, per_step[1] * steps]
                backend_ok = res["backend"] == ("nccl" if name != "tpu_native" else None)
                print(f"[dp] {name}: backend {res['backend']}, world {res['world']}, "
                      f"{res['precision']}, explicit {res['explicit']}, wire {res['wire']}, "
                      f"launches K4/K5 {res['launches']} over {res['steps']} steps, losses "
                      f"{res['losses']}, eval {res['eval']}, run {res['run_s']} s, processes "
                      f"{' + '.join(group)} {res['wall_s']} s; card {card}")
                if not (backend_ok and res["launches"] == want and res["steps"] == steps
                        and all(math.isfinite(x) for x in res["losses"] + res["eval"][:1])):
                    raise SystemExit(f"{name}: backend {res['backend']}, launches "
                                     f"{res['launches']} (expected {want}) or losses wrong:\n"
                                     f"{log[-3000:]}")
                launches[0] += res["launches"][0]
                launches[1] += res["launches"][1]

        # distributed (DDP over NCCL, world 1) against tpu_native (no group).
        a = torch.load(os.path.join(root, "distributed", "state.pt"))
        b = torch.load(os.path.join(root, "tpu_native", "state.pt"))
        same = (results["distributed"]["losses"] == results["tpu_native"]["losses"]
                and all(torch.equal(a[k], b[k]) for k in b))
        worst = max((a[k].float() - b[k].float()).abs().max().item() for k in b)
        print(f"[dp] distributed (DDP, NCCL, world 1) vs tpu_native (no group) after {steps} "
              f"steps: bitwise {'equal' if same else 'DIFFERENT'} (max abs diff {worst}); "
              f"card {card}")
        if not same:
            raise SystemExit("distributed at world 1 is not bitwise equal to tpu_native")
        d, t = results["distributed"], results["tpu_native"]
        print(f"[dp] train step on one device batch of {batch}, bf16, median of 7: DDP world "
              f"1 {d['step_ms']} ms (all {d['step_ms_all']}), no group {t['step_ms']} ms (all "
              f"{t['step_ms_all']}), overhead {d['step_ms'] - t['step_ms']} ms; all-reduce of "
              f"ResNet-50's {d['allreduce_bytes']} gradient bytes over NCCL at world 1: "
              f"{d['allreduce_ms']} ms (median of 10); card {card}")

        world_invariance(card, root, dp_args(steps, small), steps, small, per_step)
        sync_bn_check(card, root, steps, small)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


SYNC_BN_REFUSAL = ("--sync-bn and --fused-convbn are mutually exclusive: the fused conv+BN "
                   "backward has no cross-replica statistics variant; drop one of the flags")


@contextlib.contextmanager
def _environ(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sync_bn_check(card, root, steps=3, batch=256):
    """Phase 16's ``--sync-bn`` (the explicit step's cross-replica
    BatchNorm), ``horovod_distributed`` without ``--fused-convbn`` (the
    explicit step refuses the two together), f32, TF32 off, ``--grad-compress
    none``: at world 1 over NCCL the flag must change no bit; 2 gloo ranks of
    b``batch // 2`` with it must match that world-1 run within ``WORLD_*``,
    and the same 2 ranks without it (per-rank BatchNorm, the control) must
    not; the flag with ``--fused-convbn`` must exit with the JAX message."""
    args = [a for a in dp_args(steps, batch) if a != "--fused-convbn"] + [
        "--precision", "fp32", "--grad-compress", "none"]
    runs = {}
    # All four runs share the card at once (six processes).
    for pair in ((("world 1", 1, []), ("world 1 --sync-bn", 1, ["--sync-bn"]),
                  ("world 2 --sync-bn", 2, ["--sync-bn"]),
                  ("control: world 2 per-rank BatchNorm", 2, [])),):
        procs, t0 = [], time.perf_counter()
        for tag, world, extra in pair:
            out = os.path.join(root, "sync_bn_" + re.sub(r"\W+", "_", tag))
            port = _free_port()
            procs += [_launch("horovod_distributed", out,
                              args + extra + ["--checkpoint-dir", os.path.join(out, "ckpt")],
                              ("--tf32-off",),
                              {"PTD_TPU_COORDINATOR": f"127.0.0.1:{port}",
                               "PTD_TPU_NUM_PROCESSES": str(world),
                               "PTD_TPU_PROCESS_ID": str(r)})
                      for r in range(world)]
        _wait(procs, "horovod_distributed (" + " and ".join(t for t, _, _ in pair) + ")")
        for tag, world, _ in pair:
            out = os.path.join(root, "sync_bn_" + re.sub(r"\W+", "_", tag))
            res = []
            for r in range(world):
                with open(os.path.join(out, f"result{r}.json")) as f:
                    res.append(json.load(f))
            runs[tag] = (res, torch.load(os.path.join(out, "state.pt")),
                         time.perf_counter() - t0)
            want_backend = "nccl" if world == 1 else "gloo"
            if not (all(r["backend"] == want_backend and r["explicit"] for r in res)
                    and all(r["losses"] == res[0]["losses"] for r in res)
                    and all(math.isfinite(x) for x in res[0]["losses"])):
                raise SystemExit(f"horovod_distributed ({tag}): backend, explicit step or "
                                 f"losses wrong: {res}")
    (r1, s1, t1), (rs, ss, _) = runs["world 1"], runs["world 1 --sync-bn"]
    same = r1[0]["losses"] == rs[0]["losses"] and all(torch.equal(s1[k], ss[k]) for k in s1)
    print(f"[dp] horovod_distributed --sync-bn at world 1 (NCCL, f32, TF32 off, unfused, "
          f"{steps} steps) vs without: bitwise {'equal' if same else 'DIFFERENT'}, losses "
          f"{rs[0]['losses']} vs {r1[0]['losses']} (all four runs side by side: {t1} s); "
          f"card {card}")
    if not same:
        raise SystemExit("--sync-bn changed the explicit step at world 1")
    for tag in ("world 2 --sync-bn", "control: world 2 per-rank BatchNorm"):
        r2, s2, t2 = runs[tag]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r2[0]["losses"], r1[0]["losses"]))
        worst = max((s2[k].float() - w.float()).abs().max().item() for k, w in s1.items())
        within = loss_rel <= WORLD_LOSS_REL and worst <= WORLD_WEIGHT_ABS
        print(f"[dp] explicit step world invariance ({tag}), f32 TF32 off, {steps} steps: 2 "
              f"ranks x b{batch // 2} over gloo (all four runs side by side: {t2} s) vs 1 rank x "
              f"b{batch} over NCCL: "
              f"losses {r2[0]['losses']} vs {r1[0]['losses']} (max rel {loss_rel}, limit "
              f"{WORLD_LOSS_REL}); weights and statistics max abs diff {worst} (limit "
              f"{WORLD_WEIGHT_ABS}); within the limits: {within}; card {card}")
        if within != tag.startswith("world 2"):
            raise SystemExit(f"explicit step world invariance ({tag}): within the limits "
                             f"{within}")
    from pytorch_distributed_tpu_torch.recipes import horovod_distributed

    out = os.path.join(root, "sync_bn_refusal")
    with _environ(PTD_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", PTD_TPU_NUM_PROCESSES="1",
                  PTD_TPU_PROCESS_ID="0"):
        try:
            horovod_distributed.main(dp_args(1, 8) + [
                "--sync-bn", "--checkpoint-dir", out, "--epoch-csv",
                os.path.join(out, "epochs.csv"), "--device", "cuda"])
            message = None
        except ValueError as e:
            message = str(e)
    print(f"[dp] horovod_distributed --sync-bn --fused-convbn: {message!r}; group left up: "
          f"{torch.distributed.is_initialized()}")
    if message != SYNC_BN_REFUSAL or torch.distributed.is_initialized():
        raise SystemExit("--sync-bn --fused-convbn on the explicit step was not refused "
                         "with the JAX message")


def world_invariance(card, root, common, steps=3, batch=256, per_step=(33, 13)):
    """Phase 16's world-invariance check: ``multiprocessing_distributed`` at
    2 ranks of b128 sharing the card over gloo against 1 rank of b256, f32,
    TF32 off; then the same 2 ranks with each fault the check must see
    (controls), each of which must fail it.  Readings: the losses' largest
    relative difference and the weights' and statistics' largest absolute
    difference after ``steps`` steps, and, after training, K4's and K5's
    layers over the ranks against one rank (``layer_check``)."""
    f32 = common + ["--precision", "fp32"]
    out1 = os.path.join(root, "world1")
    runs = (("sound", ()), ("control: per-rank BatchNorm", ("--per-rank-bn",)),
            ("control: K4/K5 vectors from local sums", ("--local-k45-vectors",)))

    def world2(control):
        out2 = os.path.join(root, "world2" + "".join(control))
        port = _free_port()
        return [_launch("multiprocessing_distributed", out2,
                        f32 + ["--checkpoint-dir", os.path.join(out2, "ckpt")],
                        ("--tf32-off", "--layer-check", *control),
                        {"PTD_TPU_COORDINATOR": f"127.0.0.1:{port}",
                         "PTD_TPU_NUM_PROCESSES": "2", "PTD_TPU_PROCESS_ID": str(r)})
                for r in range(2)]

    # World 1, the sound world 2 and both controls share the card at once
    # (seven processes).
    t0 = time.perf_counter()
    _wait([_launch("multiprocessing_distributed", out1,
                   f32 + ["--checkpoint-dir", os.path.join(out1, "ckpt")], ("--tf32-off",),
                   {"PTD_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}"})]
          + world2(()) + world2(runs[1][1]) + world2(runs[2][1]),
          "world 1 f32, world 2 f32 (sound) and both controls")
    pair_s = dict.fromkeys([tag for tag, _ in runs], time.perf_counter() - t0)
    with open(os.path.join(out1, "result0.json")) as f:
        r1 = json.load(f)
    s1 = torch.load(os.path.join(out1, "state.pt"))
    want_launches, failed = [per_step[0] * steps, per_step[1] * steps], []
    for tag, control in runs:
        out2 = os.path.join(root, "world2" + "".join(control))
        w2_s = pair_s[tag]
        r2 = []
        for r in range(2):
            with open(os.path.join(out2, f"result{r}.json")) as f:
                r2.append(json.load(f))
        s2 = torch.load(os.path.join(out2, "state.pt"))
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r2[0]["losses"], r1["losses"]))
        worst = max((s2[k].float() - want.float()).abs().max().item() for k, want in s1.items())
        layer = max(max(r["layer_err"].values()) for r in r2)
        within = loss_rel <= WORLD_LOSS_REL and worst <= WORLD_WEIGHT_ABS and layer <= WORLD_LAYER
        print(f"[dp] world invariance ({tag}), f32 TF32 off, {steps} steps: 2 ranks x "
              f"b{batch // 2} over {r2[0]['backend']} on one card (all seven processes side by side: "
              f"{w2_s} s) vs 1 rank x b{batch} over {r1['backend']}: losses {r2[0]['losses']} "
              f"vs {r1['losses']} "
              f"(max rel {loss_rel}, limit {WORLD_LOSS_REL}); rank losses equal "
              f"{r2[0]['losses'] == r2[1]['losses']}; weights and statistics max abs diff "
              f"{worst} (limit {WORLD_WEIGHT_ABS}); K4/K5 layers over the 2 ranks vs 1, "
              f"largest difference over the reference's largest: {r2[0]['layer_err']} / "
              f"{r2[1]['layer_err']} (limit {WORLD_LAYER}); within the limits: {within}; "
              f"card {card}")
        if not (r2[0]["backend"] == "gloo" and r1["backend"] == "nccl"
                and r2[0]["losses"] == r2[1]["losses"]
                and r2[0]["launches"] == r1["launches"] == want_launches):
            raise SystemExit(f"world 2 ({tag}): backend, rank losses or launches wrong")
        if within != (not control):
            failed.append("world 2 does not match world 1" if not control else
                          f"the world-invariance check cannot see its {tag}")
    if failed:
        raise SystemExit("; ".join(failed))


def _param_bytes(model) -> int:
    """Bytes the model keeps on the card: parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def _first_diff(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), len(want))


def _greedy_rule(model, prompt, got, want, gap_limit, what):
    """Each row of ``got`` equals ``want`` up to its first difference, and
    there ``model``'s top-2 logit gap (teacher-forced on the prompt and
    ``want``) is under ``gap_limit``; returns the tokens compared (before
    the first difference) and the gaps found at differences."""
    compared, gaps = 0, []
    for b in range(prompt.shape[0]):
        g, w = got[b].tolist(), want[b].tolist()
        j = _first_diff(g, w)
        compared += j
        if j < len(w):
            seq = torch.cat([prompt[b:b + 1], want[b:b + 1, :j].to(prompt.dtype)], dim=1)
            with torch.no_grad():
                gap = _top2_gaps(model(seq)[0, -1])
            gaps.append(gap)
            if not gap < gap_limit:
                raise SystemExit(f"{what}: row {b} differs at token {j}, where the reference's "
                                 f"top-2 logit gap is {gap} (limit {gap_limit})")
    return compared, gaps


def fused_ce_phase(dev, card, cfg, steps=8, TB=4, TL=4096, chunks=8):
    """Phase 17: ``lm_pretrain --fused-ce`` at the LM cell's full width.
    Returns the (K1, K2, K3) launches of its training runs and the unfused
    bf16 step's median ms."""

    # f32, TF32 off: the fused loss against the unfused head on the same
    # weights and tokens.  They differ in summation order only (the head's
    # products in row blocks, the softmax sums per block): loss 1e-5
    # relative, gradients 1e-3 of their largest, as phase 7's flash-vs-dense
    # check holds the same model.
    tokens = torch.from_numpy(SyntheticTokenDataset(TB, TL, cfg["vocab_size"]).batch(0, TB)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs, weights, peak = {}, None, {}
    for n in (chunks, 0):
        model = TransformerLM(**cfg, dtype=torch.float32, device=dev)
        if weights is None:
            weights = model.init_weights(torch.Generator(device=dev).manual_seed(0)).state_dict()
        else:
            model.load_state_dict(weights)
        torch.cuda.reset_peak_memory_stats()
        loss = lm_loss(model, tokens, n)[0]
        loss.backward()
        torch.cuda.synchronize()
        peak[n] = torch.cuda.max_memory_allocated() / 2**30
        last = f"blocks.{cfg['n_layers'] - 1}."
        runs[n] = (loss.item(), {k: p.grad for k, p in model.named_parameters()
                                 if k.startswith(("embed.", "ln_f.", last))})
        del model, loss
    del weights
    (lf, gf), (lu, gu) = runs[chunks], runs[0]
    loss_err = abs(lf - lu) / abs(lu)
    rel = {k: ((g - gu[k]).abs().max() / gu[k].abs().max()).item() for k, g in gf.items()}
    worst = max(rel, key=rel.get)
    print(f"[fused-ce] f32 TF32 off, B={TB} L={TL}, {chunks} chunks vs the unfused head: loss "
          f"{lf} vs {lu} (rel err {loss_err:.3e}, limit 1e-5); worst gradient of embed, ln_f "
          f"and the last block {worst} rel err {rel[worst]:.3e} (limit 1e-3 of its max); peak "
          f"memory of the step {peak[chunks]} vs {peak[0]} GiB; card {card}")
    if not (loss_err <= 1e-5 and all(r <= 1e-3 for r in rel.values())):
        raise SystemExit("the fused CE loss disagrees with the unfused head")
    del runs, gf, gu
    torch.cuda.empty_cache()

    # bf16 through the recipe, fused then unfused: step time and memory.
    total = [0, 0, 0]
    for n in (chunks, 0):
        flash_attention.launches = 0
        flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = lm_pretrain.run([
            "--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
            "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
            "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision", "bf16",
            "--no-eval", "--fused-ce", str(n), "-p", "4", "--device", str(dev)])
        torch.cuda.synchronize()
        launches = (flash_attention.launches, flash_attention_bwd_dq.launches,
                    flash_attention_bwd_dkv.launches)
        losses = [float(x) for x in trainer.losses]
        step_ms = statistics.median(trainer.step_times[1:]) * 1e3
        print(f"[fused-ce] lm_pretrain --fused-ce {n} B={TB} L={TL} bf16 compute, f32 weights: "
              f"step {step_ms} ms (median of steps 2-{steps}; all "
              f"{[t * 1e3 for t in trainer.step_times]}), {TB * TL / step_ms * 1e3} tokens/s; "
              f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30} GiB; losses "
              f"{losses}; launches K1/K2/K3 {launches}; card {card}")
        if launches != (cfg["n_layers"] * steps,) * 3:
            raise SystemExit(f"--fused-ce {n} training launched (K1, K2, K3) {launches} "
                             f"times in {steps} steps")
        if n == 0:
            unfused_ms = step_ms  # phase 20's LM baseline
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"non-finite --fused-ce {n} loss: {losses}")
        total = [a + b for a, b in zip(total, launches)]
        del trainer
    torch.cuda.empty_cache()
    return total, unfused_ms


def _decode_times(model, prompt, n_new, reps=3):
    """``[(prefill + first token ms, decode ms/token)]`` of ``generate``,
    ``reps`` times."""
    out = []
    for _ in range(reps):
        times = {}
        for n in (1, n_new + 1):
            t0 = time.perf_counter()
            generate(model, prompt, n)
            torch.cuda.synchronize()
            times[n] = (time.perf_counter() - t0) * 1e3
        out.append((times[1], (times[n_new + 1] - times[1]) / n_new))
    return out


def generate_variants_phase(dev, card, cfg, B=4, P=4096, N=32, gamma=4, SP=512, SN=64):
    """Phase 18: int8 weight-only ``generate`` and speculative decoding at
    the LM's full width.  Returns the K1 launches of its int8 prefills."""
    from pytorch_distributed_tpu_torch.models.quant import QuantDense, quantize_lm
    from pytorch_distributed_tpu_torch.models.speculative import speculative_generate

    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg["vocab_size"], (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    flash_attention.launches = 0
    fp = TransformerLM(**cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev)
    fp.init_weights(torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    q = quantize_lm(fp)
    quant_s = time.perf_counter() - t0
    bf16 = TransformerLM(**cfg, dtype=torch.bfloat16, device=dev)
    bf16.load_state_dict(fp.state_dict())
    del fp
    generate(q, prompt, 2)  # warm-up
    generate(bf16, prompt, 2)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = {"int8": _decode_times(q, prompt, N)}
    k1 = flash_attention.launches
    int8_peak = torch.cuda.max_memory_allocated() / 2**30
    times["bf16"] = _decode_times(bf16, prompt, N)
    if k1 != cfg["n_layers"] * 2 * len(times["int8"]):
        raise SystemExit(f"int8 generate launched K1 {k1} times in {2 * len(times['int8'])} "
                         f"prefills of {cfg['n_layers']} layers")
    for name, model in (("int8", q), ("bf16", bf16)):
        print(f"[int8] {name} B={B} P={P}: (prefill + first token ms, decode ms/token) "
              f"{times[name]}; resident parameter bytes {_param_bytes(model)}; card {card}")
    print(f"[int8] quantized in {quant_s} s; K1 launches {k1} over {2 * len(times['int8'])} "
          f"int8 prefills; peak memory of the int8 runs {int8_peak} GiB")
    del bf16

    # Greedy tokens against the dequantized weights w_q * scale, held in the
    # same compute dtype: bf16, then f32 (TF32 off).
    for dtype in (torch.bfloat16, torch.float32):
        qd = q if dtype == torch.bfloat16 else TransformerLM(**dict(q.config, dtype=dtype,
                                                                  param_dtype=dtype))
        if qd is not q:
            qd.load_state_dict(q.state_dict())
        deq = TransformerLM(**cfg, dtype=dtype, param_dtype=torch.float32, device=dev)
        sd = {}
        for k, t in qd.state_dict().items():
            if k.endswith(".w_q"):
                sd[k[:-4] + ".weight"] = t.float() * qd.state_dict()[k[:-4] + ".scale"][:, None]
            elif not k.endswith(".scale"):
                sd[k] = t.float()
        deq.load_state_dict(sd)
        got, want = generate(qd, prompt, N), generate(deq, prompt, N)
        with torch.no_grad():
            lq, ld = (m(prompt[:1]).float()[0, -1] for m in (qd, deq))
        dl = (lq - ld).abs().max().item()
        limit = 1e-3 if dtype == torch.float32 else INT8_BF16_GAP
        compared, gaps = _greedy_rule(deq, prompt, got, want, limit, f"int8 {dtype}")
        print(f"[int8] {dtype} greedy tokens vs the dequantized weights: {compared} of "
              f"{want.numel()} identical before each row's first difference; top-2 gaps there "
              f"{gaps} (limit {limit}); last prefill logit max |int8 - dequantized| {dl}")
        if not isinstance(qd.blocks[0].attn.qkv, QuantDense):
            raise SystemExit("the int8 model has no QuantDense")
        del qd, deq, got, want
    del q
    torch.cuda.empty_cache()

    # Speculative decoding, batch 1, f32 (TF32 off): against the target's
    # own greedy stream (dense cache path), with the default random draft
    # and with the target as its own draft.
    target = TransformerLM(**cfg, dtype=torch.float32, device=dev)
    target.init_weights(torch.Generator(device=dev).manual_seed(0))
    draft = TransformerLM(vocab_size=cfg["vocab_size"], d_model=max(32, cfg["d_model"] // 4),
                          n_heads=max(1, cfg["n_heads"] // 4),
                          n_layers=max(1, cfg["n_layers"] // 4), dtype=torch.float32,
                          device=dev)
    draft.init_weights(torch.Generator(device=dev).manual_seed(1))
    sp = prompt[:1, :SP]
    greedy_generate(target, sp, 4, flash_prefill=False)  # warm-up
    speculative_generate(target, draft, sp, 8, gamma=gamma)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    want = greedy_generate(target, sp, SN, flash_prefill=False)
    torch.cuda.synchronize()
    greedy_ms = (time.perf_counter() - t0) * 1e3 / SN
    for name, d in (("random draft", draft), ("self draft", target)):
        t0 = time.perf_counter()
        got, stats = speculative_generate(target, d, sp, SN, gamma=gamma)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SN
        compared, gaps = _greedy_rule(target, sp, got, want, 1e-3, f"speculative ({name})")
        print(f"[spec] {name} gamma={gamma}, P={SP}, {SN} tokens, f32: {compared} of {SN} "
              f"tokens identical to greedy_generate before the first difference (gaps there "
              f"{gaps}); stats {stats}; {ms} ms/token against greedy {greedy_ms} ms/token; "
              f"card {card}")
        if name == "self draft" and stats["tokens_per_target_pass"] < 0.9 * (gamma + 1):
            raise SystemExit(f"self-draft speculation made {stats['tokens_per_target_pass']} "
                             f"tokens per target pass, under {0.9 * (gamma + 1)}")
    if flash_attention.launches:
        raise SystemExit("speculative decoding at P=512 launched K1")
    del target, draft
    torch.cuda.empty_cache()

    rc = lm_generate.main([
        "--random-init", "--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
        "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
        "--precision", "bf16", "--quant", "int8", "--spec-draft", "random",
        "--prompt-tokens", ",".join(str(t) for t in sp[0].tolist()), "-n", "16",
        "--device", str(dev)])
    if rc != 0:
        raise SystemExit(f"lm_generate --quant int8 --spec-draft random returned {rc}")
    torch.cuda.empty_cache()
    return k1


def engine_variants_phase(dev, card, lm, kv_blocks=385, n_requests=16, n_dense=8, gamma=3):
    """Phase 19: the serving engine of phase 12 at int8 and with a
    speculative draft, on a trace cut to ``n_requests``."""
    from pytorch_distributed_tpu_torch.models.quant import quantize_state_dict

    kernels = KERNEL_WRAPPERS
    for k in kernels:
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm_params(**lm, seed=0, device=dev)
    eng_cfg = dict(lm, max_batch=16, kv_blocks=kv_blocks, block_size=16, blocks_per_seq=64,
                   chunk_size=128, max_new_tokens=384, policy="fcfs",
                   defrag_threshold_pct=50.0, device=dev)
    load_cfg = LoadConfig(n_requests=n_requests, rate_rps=200.0, profile="mixed",
                          vocab_size=lm["vocab_size"], prompt_min=128, prompt_max=512,
                          short_min=16, short_max=64, long_min=256, long_max=384,
                          long_frac=0.2, seed=0)
    prompts = {r.rid: list(r.prompt) for _, r in generate_load(load_cfg)}
    # serve_lm's default draft is 16 wide for its 4-head toy model: head dim
    # 4.  The draft shares the target's 16 heads, so the same head dim takes
    # d_model 64 (at 16 wide a head would be 1 wide, and RoPE rotates pairs).
    draft_width = 4 * lm["n_heads"]
    draft = init_lm_params(lm["vocab_size"], draft_width, lm["n_heads"], 1, seed=1, device=dev)
    qparams = quantize_state_dict(params, device=dev)
    tokens = {}
    for name, p, kw in (("plain", params, {}), ("int8", qparams, dict(quant="int8")),
                        (f"gamma={gamma}", params, dict(gamma=gamma, draft_params=draft))):
        eng = ServingEngine(p, **eng_cfg, **kw)
        rec = _instrument(eng)
        s = eng.run(generate_load(load_cfg))
        torch.cuda.synchronize()
        tokens[name] = {r.rid: list(r.generated) for r in eng.finished}
        replay_ms = [a.elapsed_time(b) for a, b in rec["replay_events"]]
        wall_ms = [t * 1e3 for t in rec["decode_s"]]
        print(f"[engine+] {name}: {s['completed']}/{n_requests} requests, {s['tokens']} tokens "
              f"in {s['wall_s']} s, {s['tokens_per_s']} tokens/s; TTFT p50 {s['ttft_p50_ms']} "
              f"ms; ITL p50 {s['itl_p50_ms']} ms; {eng.decode_iterations} decode iterations "
              f"in {s['steps']} steps, iteration wall median {statistics.median(wall_ms)} ms, "
              f"graph replay (decode step or speculative round) device median "
              f"{statistics.median(replay_ms)} ms; graph captures {eng.graph_captures}, "
              f"replays {eng.graph_replays}; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30} GiB; card {card}")
        if s["completed"] != n_requests or eng.graph_captures != 1 or (
                eng.graph_replays != eng.decode_iterations):
            raise SystemExit(f"{name} engine: {s['completed']} of {n_requests} completed, "
                             f"{eng.graph_captures} captures, {eng.graph_replays} replays in "
                             f"{eng.decode_iterations} iterations")
        del eng, rec
        gc.collect()
        torch.cuda.empty_cache()

    def dense_model(**kw):
        m = TransformerLM(**lm, dtype=torch.float32, device=dev, attn_impl="dense", **kw)
        m.load_state_dict(qparams if kw else params)
        return m

    # The speculative engine against the plain one: identical tokens up to
    # a first difference where the dense path's top-2 gap is under 1e-3.
    dense = dense_model()
    spec_same = 0
    for rid, want in tokens["plain"].items():
        got = tokens[f"gamma={gamma}"][rid]
        j = _first_diff(got, want)
        spec_same += j
        if j < len(want):
            _greedy_rule(dense, torch.tensor([prompts[rid]], device=dev),
                         torch.tensor([got], device=dev), torch.tensor([want], device=dev),
                         1e-3, f"speculative engine rid {rid}")
    total = sum(len(t) for t in tokens["plain"].values())
    print(f"[engine+] gamma={gamma} vs the engine without a draft: {spec_same} of {total} "
          f"tokens identical before each request's first difference")
    del dense
    # The int8 engine against the int8 dense path (phase 12's rule).
    dense = dense_model(quant="int8")
    compared = total = 0
    for rid in range(n_dense):
        got = tokens["int8"][rid]
        want = greedy_generate(dense, torch.tensor([prompts[rid]], device=dev), len(got),
                               flash_prefill=False)
        c, _ = _greedy_rule(dense, torch.tensor([prompts[rid]], device=dev),
                            torch.tensor([got], device=dev), want, 1e-3, f"int8 engine rid {rid}")
        compared += c
        total += len(got)
    print(f"[engine+] int8, first {n_dense} requests against the int8 dense path: {compared} "
          f"of {total} tokens identical before the first difference")
    if compared < 0.9 * total:
        raise SystemExit(f"only {compared} of {total} int8 tokens compared with the dense path")
    del dense, params, qparams, draft

    os.makedirs("build", exist_ok=True)
    rc = serve_lm.main([
        "--vocab-size", str(lm["vocab_size"]), "--d-model", str(lm["d_model"]),
        "--n-heads", str(lm["n_heads"]), "--n-layers", str(lm["n_layers"]),
        "--max-batch", "16", "--kv-blocks", str(kv_blocks), "--block-size", "16",
        "--blocks-per-seq", "64", "--chunk-size", "128", "--max-new-tokens", "64",
        "--requests", "8", "--quant", "int8", "--gamma", str(gamma),
        "--draft-d-model", str(draft_width),
        "--summary-json", "build/serve_lm_variants.json", "--device", str(dev)])
    with open("build/serve_lm_variants.json") as f:
        completed = json.load(f)["completed"]
    print(f"[engine+] serve_lm.main --quant int8 --gamma {gamma}: rc {rc}, {completed}/8 "
          f"requests completed")
    if rc != 0 or completed != 8:
        raise SystemExit(f"serve_lm --quant int8 --gamma {gamma} returned {rc}")
    launched = [k.launches for k in kernels]
    print(f"[engine+] kernel launches K1-K5 during phase 19: {launched}")
    if any(launched):
        raise SystemExit("the serving engine launched a kernel it should not reach")
    torch.cuda.empty_cache()


# Phase 20: the gradient-communication stack (ROADMAP A9) at full width.
# The image variants run one after another in one worker process
# (``python3 chip_smoke.py --a9-worker OUT``), each through
# ``horovod_distributed`` (or ``distributed`` for the GSPMD twin) at world 1
# over NCCL (``PTD_TPU_*``), ResNet-50 --fused-convbn b256 224x224
# synthetic, bf16 compute, cuDNN deterministic, 3 steps and one eval batch.
A9_IMAGE = (("bf16 wire (baseline)", "horovod_distributed", []),
            ("int8", "horovod_distributed", ["--grad-compress", "int8"]),
            ("fp8", "horovod_distributed", ["--grad-compress", "fp8"]),
            ("wus, bf16 wire", "horovod_distributed", ["--zero", "wus"]),
            ("wus int8", "horovod_distributed", ["--zero", "wus", "--grad-compress", "int8"]),
            ("bucketed 4 MiB, bf16 wire", "horovod_distributed",
             ["--overlap", "bucketed", "--bucket-mb", "4"]),
            ("f32 wire", "horovod_distributed", ["--grad-compress", "none"]),
            ("f32 wire bucketed 4 MiB", "horovod_distributed",
             ["--grad-compress", "none", "--overlap", "bucketed", "--bucket-mb", "4"]),
            ("f32 wire wus", "horovod_distributed", ["--grad-compress", "none", "--zero", "wus"]),
            ("distributed --zero wus (GSPMD twin)", "distributed", ["--zero", "wus"]))


def _plain_fake_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """The int8 round trip of one leaf (JAX layout), written out plainly:
    blocks of 256 over the zero-padded flat leaf, ``scale = absmax *
    f32(1/127)`` (as XLA compiles the JAX package's ``absmax / 127``),
    ``round(clip(x * 127/absmax))`` half to even, times the scale."""
    flat = x.float().reshape(-1)
    xb = F.pad(flat, (0, (-flat.numel()) % 256)).view(-1, 256)
    absmax = xb.abs().amax(-1, keepdim=True)
    q127 = torch.full((), 127.0, device=x.device)
    scale = absmax * torch.full((), float(np.float32(1) / np.float32(127)), device=x.device)
    inv = torch.where(absmax > 0, q127 / absmax, torch.zeros((), device=x.device))
    q = torch.round(torch.clamp(xb * inv, -127.0, 127.0)).to(torch.int8)
    return (q.float() * scale).reshape(-1)[:flat.numel()].view(x.shape)


def _timed(fn, store):
    """``fn`` with each call's wall time, closed by synchronises, appended
    (ms) to ``store``."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        store.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def a9_worker(argv) -> int:
    """Phase 20's image variants in this process (see ``A9_IMAGE``), then the
    int8 resume; writes OUT/a9.json."""
    import importlib

    from pytorch_distributed_tpu_torch.ops import qcomm
    from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
    from pytorch_distributed_tpu_torch.utils.convert import jax_leaves

    out, size = argv[0], argv[1:]  # size: recipe flags that cut the run (a CPU rehearsal)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    os.environ.update(PTD_TPU_NUM_PROCESSES="1", PTD_TPU_PROCESS_ID="0")
    common = dp_args(3, 256) + ["--precision", "bf16"] + size
    results, states = [], {}
    capture = {"on": False}
    real_sync, real_step = gradsync.GradSync.sync_explicit, torch.optim.SGD.step

    def sync_capture(self, count):
        if capture["on"] and "g" not in capture:  # the first step's local sums
            capture.update(g=[p.grad.detach().clone() for p in self.params], count=count.clone(),
                           p=[p.detach().clone() for p in self.params], leaves=self.leaves)
        return real_sync(self, count)

    def step_capture(self, *a, **k):
        r = real_step(self, *a, **k)
        if capture["on"] and "g" in capture and "m" not in capture:
            capture["m"] = [self.state[p]["momentum_buffer"].clone()
                            for p in capture["params"]]
        return r

    gradsync.GradSync.sync_explicit = sync_capture
    torch.optim.SGD.step = step_capture
    for tag, name, extra in A9_IMAGE:
        os.environ["PTD_TPU_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
        mod = importlib.import_module(f"pytorch_distributed_tpu_torch.recipes.{name}")
        trainers = []
        mod.finish = lambda t: trainers.append(t) or t.best_acc1  # keep the group up
        capture.clear()
        capture["on"] = "int8" == tag
        d = tempfile.mkdtemp(prefix="a9_", dir=out)
        fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
        if capture["on"]:
            capture["params"] = None  # set below, once the model exists
            real_init = gradsync.GradSync.__init__

            def init_capture(self, model, *a, **k):
                real_init(self, model, *a, **k)
                capture["params"] = self.params
            gradsync.GradSync.__init__ = init_capture
        t0 = time.perf_counter()
        mod.main(common + extra + ["--checkpoint-dir", d, "--epoch-csv",
                                   os.path.join(d, "epochs.csv")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        if capture["on"]:
            gradsync.GradSync.__init__ = real_init
        launches = [fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches]
        (trainer,) = trainers
        capture["on"] = False
        comm = trainer.comm
        res = {"tag": tag, "recipe": name, "backend": trainer.ctx.backend,
               "world": trainer.ctx.process_count, "launches": launches,
               "steps": len(trainer.losses), "losses": [float(x) for x in trainer.losses],
               "run_s": run_s, "buckets": len(comm.buckets),
               "momentum_bytes": gradsync.momentum_bytes(trainer.optimizer, comm)}
        if tag in ("f32 wire", "f32 wire bucketed 4 MiB", "f32 wire wus"):
            states[tag] = ([float(x) for x in trainer.losses],
                           {k: v.detach().clone() for k, v in trainer.model.state_dict().items()})
        if "m" in capture:
            # The first update against the plain chain: the local sums
            # through two int8 round trips (JAX at one rank: the all-to-all
            # stage, then the re-quantized all-gather), divided by the
            # count, plus the weight decay as torch's SGD adds it.
            same = total = 0
            for leaf, g, p, m in zip(capture["leaves"], capture["g"], capture["p"],
                                     capture["m"]):
                fq = leaf.from_jax(_plain_fake_quantize_int8(
                    _plain_fake_quantize_int8(leaf.to_jax(g))))
                want = (fq / capture["count"]).add(p, alpha=trainer.cfg.weight_decay)
                same += int((want == m).sum())
                total += m.numel()
            res["first_update_equal"], res["first_update_total"] = same, total
        # The train step alone on one device batch: 2 warm-ups, median of 7;
        # then 3 more with the sync stage closed by synchronises, its time.
        dev = trainer.device
        g = torch.Generator(device=dev).manual_seed(1)
        b = trainer.local_batch
        side, classes = trainer.cfg.image_size, trainer.cfg.num_classes
        batch = {"images": torch.randn(b, side, side, 3, device=dev, generator=g),
                 "labels": torch.randint(0, classes, (b,), device=dev, generator=g),
                 "weights": torch.ones(b, device=dev)}
        times = []
        for _ in range(9):
            t0 = time.perf_counter()
            trainer.train_step(batch, 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        sync_ms = []
        stage = "wus_step" if comm.wus else "sync_explicit"  # every variant has a GradSync
        setattr(comm, stage, _timed(getattr(comm, stage), sync_ms))
        for _ in range(3):
            trainer.train_step(batch, 0.1)
        delattr(comm, stage)
        res["sync_ms"] = statistics.median(sync_ms)
        res["step_ms"], res["step_ms_all"] = statistics.median(times[2:]), times
        results.append(res)
        shutdown(trainer.ctx)
        shutil.rmtree(d, ignore_errors=True)
        del trainer, trainers, comm
        gc.collect()
        torch.cuda.empty_cache()
    gradsync.GradSync.sync_explicit, torch.optim.SGD.step = real_sync, real_step
    bitwise = {}
    base_losses, base = states["f32 wire"]
    for tag in ("f32 wire bucketed 4 MiB", "f32 wire wus"):
        losses, st = states[tag]
        bitwise[tag] = losses == base_losses and all(torch.equal(st[k], base[k]) for k in base)

    # The int8 resume: a 4-step epoch stopped after step 2 (where
    # --save-steps 2 saved), resumed; the residual rides in the file.
    os.environ["PTD_TPU_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
    img = dp_args(4, 256) + ["--precision", "bf16", "--grad-compress", "int8"] + size
    ctx = initialize(device=parse_config(img).device)
    d = tempfile.mkdtemp(prefix="a9_resume_", dir=out)

    def full_state(t):
        st = _state(t.model, t.optimizer)
        res_tree = t.comm.checkpoint_trees()["residual"]
        for leaf, v in zip(jax_leaves(t.model), qcomm.tree_leaves(res_tree)):
            st[f"residual:{leaf.name}"] = torch.from_numpy(v)
        return st

    ref = Trainer(parse_config(img + ["--checkpoint-dir", os.path.join(d, "ref")]), ctx,
                  explicit_collectives=True)
    ref.fit()
    want_losses, want = [float(x) for x in ref.losses], full_state(ref)
    del ref
    first = Trainer(parse_config(img + ["--checkpoint-dir", os.path.join(d, "run"),
                                        "--save-steps", "2"]), ctx, explicit_collectives=True)
    stopped = first.train_epoch(0, stop_after=2)
    first_losses = [float(x) for x in first.losses]
    del first
    fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
    resumed = Trainer(parse_config(img + ["--checkpoint-dir", os.path.join(d, "run"), "--resume",
                                          os.path.join(d, "run", CHECKPOINT_NAME)]), ctx,
                      explicit_collectives=True)
    resumed.fit()
    torch.cuda.synchronize()
    got = full_state(resumed)
    losses = first_losses + [float(x) for x in resumed.losses]
    resume = {"stopped": stopped, "losses": losses, "want_losses": want_losses,
              "launches": [fused_dgrad_wgrad.launches, fused_dgrad_wgrad_3x3.launches],
              "steps": len(resumed.losses),
              "bitwise": losses == want_losses and all(torch.equal(t, want[k])
                                                       for k, t in got.items()),
              "worst": max((t.float() - want[k].float()).abs().max().item()
                           for k, t in got.items()),
              "residual_sum": float(sum(t.abs().sum() for k, t in got.items()
                                        if k.startswith("residual:")))}
    shutdown(ctx)
    shutil.rmtree(d, ignore_errors=True)
    with open(os.path.join(out, "a9.json"), "w") as f:
        json.dump({"variants": results, "bitwise": bitwise, "resume": resume}, f)
    return 0


def _json(path):
    with open(path) as f:
        return json.load(f)


def a9_phase(dev, card, cfg, lm_base_ms, TB=4, TL=4096, steps=8, per_step=(33, 13), size=()):
    """Phase 20: the gradient-communication stack at full width (``size``:
    recipe flags that cut the image runs, for a rehearsal; ``lm_base_ms``:
    phase 17's unfused LM step).  Returns the (K1, K2, K3, K4, K5) launches
    of its runs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_a9_")
    try:
        # --zero wus on the explicit step, f32, TF32 off: 1 rank of b256 over
        # NCCL and 2 gloo ranks of b128 sharing the card, three processes at
        # once; then the image variants alone on the card, one process.  The
        # explicit step's BatchNorm is per rank unless --sync-bn, which it
        # refuses with --fused-convbn (phase 16's sync_bn_check).
        t0 = time.perf_counter()
        args = [a for a in dp_args(3, 256) if a != "--fused-convbn"] + [
            "--precision", "fp32", "--grad-compress", "none", "--zero", "wus",
            "--sync-bn"] + list(size)
        procs = []
        for world in (1, 2):
            o = os.path.join(root, f"wus_world{world}")
            port = _free_port()
            procs += [_launch("horovod_distributed", o,
                              args + ["--checkpoint-dir", os.path.join(o, "ckpt")],
                              ("--tf32-off",),
                              {"PTD_TPU_COORDINATOR": f"127.0.0.1:{port}",
                               "PTD_TPU_NUM_PROCESSES": str(world),
                               "PTD_TPU_PROCESS_ID": str(r)}) for r in range(world)]
        _wait(procs, "horovod_distributed --zero wus at world 1 and 2")
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                                 "--a9-worker", root, *size],
                                env={**os.environ, "PYTHONPATH": here + os.pathsep
                                     + os.environ.get("PYTHONPATH", "")}, cwd=root,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _wait([proc], "the phase-20 image worker", timeout=900)
        worker_s = time.perf_counter() - t0
        rec = _json(os.path.join(root, "a9.json"))
        r1 = _json(os.path.join(root, "wus_world1", "result0.json"))
        r2 = [_json(os.path.join(root, "wus_world2", f"result{r}.json")) for r in range(2)]
        s1 = torch.load(os.path.join(root, "wus_world1", "state.pt"))
        s2 = torch.load(os.path.join(root, "wus_world2", "state.pt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed, k45 = [], [0, 0]
    base = rec["variants"][0]
    for v in rec["variants"]:
        want = [per_step[0] * 3, per_step[1] * 3]
        ok = (v["backend"] == "nccl" and v["world"] == 1 and v["launches"] == want
              and v["steps"] == 3 and all(math.isfinite(x) for x in v["losses"]))
        print(f"[a9] {v['recipe']} {v['tag']}: step {v['step_ms']} ms vs {base['step_ms']} ms "
              f"for the bf16-wire baseline ({v['step_ms'] - base['step_ms']:+} ms; steps "
              f"{v['step_ms_all']}); gradient sync alone {v['sync_ms']} ms (baseline's "
              f"all-reduce {base['sync_ms']} ms); {v['buckets']} bucket(s); momentum held "
              f"{v['momentum_bytes']} bytes; K4/K5 {v['launches']} over {v['steps']} steps; "
              f"losses {v['losses']}; backend {v['backend']}, world {v['world']}; run "
              f"{v['run_s']} s; card {card}")
        if not ok:
            failed.append(f"{v['tag']}: backend, launches {v['launches']} or losses wrong")
        if "first_update_equal" in v:
            print(f"[a9] int8 first update (momentum after step 1) vs the plain chain "
                  f"fake_quantize(fake_quantize(g)) / count + wd * w: "
                  f"{v['first_update_equal']} of {v['first_update_total']} elements bitwise "
                  f"equal; card {card}")
            if v["first_update_equal"] != v["first_update_total"]:
                failed.append("int8's first update is not the plain chain's bit for bit")
        k45 = [a + b for a, b in zip(k45, v["launches"])]
    for tag, same in rec["bitwise"].items():
        print(f"[a9] {tag} vs f32 wire (--overlap none, --zero none), 3 steps: bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            failed.append(f"{tag} is not bitwise equal to its plain run")
    r = rec["resume"]
    print(f"[a9] int8 resume: stopped after {r['stopped']} of 4 steps, resumed for "
          f"{r['steps']} (K4/K5 {r['launches']}): losses {r['losses']} vs uninterrupted "
          f"{r['want_losses']}; weights, statistics, momentum and residual (|residual| sum "
          f"{r['residual_sum']}) bitwise {'equal' if r['bitwise'] else 'DIFFERENT'} (worst "
          f"{r['worst']}); card {card}")
    if not (r["bitwise"] and r["stopped"] == 2 and r["residual_sum"] > 0
            and r["launches"] == [2 * per_step[0], 2 * per_step[1]]):
        failed.append("the int8 resume does not end bitwise where the uninterrupted run does")
    k45 = [a + b for a, b in zip(k45, r["launches"])]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r2[0]["losses"], r1["losses"]))
    worst = max((s2[k].float() - w.float()).abs().max().item() for k, w in s1.items())
    within = loss_rel <= WORLD_LOSS_REL and worst <= WORLD_WEIGHT_ABS
    full = r1["param_bytes"]
    print(f"[a9] --zero wus --sync-bn explicit step, unfused, f32 TF32 off, 3 steps: 2 ranks "
          f"x b128 over "
          f"{r2[0]['backend']} vs 1 x b256 over {r1['backend']} (the three processes "
          f"{pair_s} s): losses {r2[0]['losses']} vs {r1['losses']} (max rel {loss_rel}, limit "
          f"{WORLD_LOSS_REL}); weights and statistics max abs diff {worst} (limit "
          f"{WORLD_WEIGHT_ABS}); within: {within}; momentum held per rank "
          f"{[x['momentum_bytes'] for x in r2]} bytes at 2 ranks, {r1['momentum_bytes']} at 1, "
          f"replicated {full}; card {card}")
    for x in [r1] + r2:
        k45 = [a + b for a, b in zip(k45, x["launches"])]
    if not (within and r2[0]["losses"] == r2[1]["losses"] and r2[0]["backend"] == "gloo"
            and all(x["momentum_bytes"] <= full / 2 + 4 * 256 * x["n_params"] for x in r2)):
        failed.append("--zero wus at 2 ranks: outside WORLD_* or momentum not 1/2")
    print(f"[time] phase 20: the 2-rank check {pair_s} s, the image worker {worker_s} s")

    # The LM variants through lm_pretrain at the LM cell, bf16, no eval.
    lm = []
    for extra in (["--grad-compress", "int8"],
                  ["--overlap", "bucketed", "--grad-compress", "int8"]):
        flash_attention.launches = 0
        flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
        torch.cuda.empty_cache()
        trainer = lm_pretrain.run([
            "--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
            "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
            "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision", "bf16",
            "--no-eval", "-p", "4", "--device", str(dev)] + extra)
        torch.cuda.synchronize()
        launches = (flash_attention.launches, flash_attention_bwd_dq.launches,
                    flash_attention_bwd_dkv.launches)
        losses = [float(x) for x in trainer.losses]
        step_ms = statistics.median(trainer.step_times[1:]) * 1e3
        comm, sync_ms = trainer.comm, []
        stage = "sync_explicit" if comm.explicit else "emulate_grads"
        setattr(comm, stage, _timed(getattr(comm, stage), sync_ms))
        tokens = trainer._tokens(trainer.dataset, 0)
        for _ in range(3):
            trainer.step_fn(tokens, 0.01)
        print(f"[a9] lm_pretrain {' '.join(extra)} B={TB} L={TL} bf16: step {step_ms} ms vs "
              f"phase 17's unfused step {lm_base_ms} ms (all "
              f"{[t * 1e3 for t in trainer.step_times]}); sync stage alone "
              f"{statistics.median(sync_ms)} ms ({sync_ms}); {len(comm.buckets)} bucket(s); "
              f"launches K1/K2/K3 {launches}; losses {losses}; card {card}")
        if launches != (cfg["n_layers"] * steps,) * 3 or not all(map(math.isfinite, losses)):
            failed.append(f"lm_pretrain {' '.join(extra)}: launches {launches} or losses wrong")
        lm.append(launches)
        del trainer, comm
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit("phase 20: " + "; ".join(failed))
    k123 = [sum(x[i] for x in lm) for i in range(3)]
    return tuple(k123) + tuple(k45)


# Phase 21: the rest of the image zoo (ROADMAP A10's single-device archs).
ZOO_REPRESENTATIVES = (("vgg16_bn", 224, 64), ("densenet121", 224, 128),
                       ("mobilenet_v2", 224, 128), ("inception_v3", 299, 64),
                       ("shufflenet_v2_x1_0", 224, 128), ("vit_b_16", 224, 64))


def zoo_sweep(dev, card, size=64, batch=16, eval_batch=2, classes=1000):
    """Every arch beyond the ResNets, built on ``dev`` at its published width:
    one bf16 train step of ``batch`` (finite loss), then its f32 eval logits
    on ``dev`` (TF32 off) against the CPU's for the same weights and images,
    within 1e-3 of their largest (``size`` px; Inception-v3 at least 96)."""
    cpu = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    worst, rows = 0.0, []
    for name in models.model_names():
        if models.is_resnet(name):
            continue
        side = max(size, 96) if name == "inception_v3" else size
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(0)
        model = models.create_model(name, num_classes=classes, dtype=torch.bfloat16,
                                    image_size=side, device=dev).init_weights(g)
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        n_params = sum(p.numel() for p in model.parameters())
        step = make_train_step(model, sgd(model.parameters()))
        batch_d = {"images": torch.randn(batch, side, side, 3, device=dev, generator=g),
                   "labels": torch.randint(0, classes, (batch,), device=dev, generator=g),
                   "weights": torch.ones(batch, device=dev)}
        loss = float(step(batch_d, 0.01)["loss"])
        del model, step, batch_d
        x = torch.randn(eval_batch, side, side, 3, device=dev, generator=g)
        outs = []
        for where in (dev, cpu):
            m = models.create_model(name, num_classes=classes, image_size=side, device=where)
            m.load_state_dict({k: v.to(where) for k, v in weights.items()})
            with torch.no_grad():
                outs.append(m.eval()(x.to(where)).float().cpu())
            del m
        err = ((outs[0] - outs[1]).abs().max() / outs[1].abs().max()).item()
        worst = max(worst, err)
        ok = math.isfinite(loss) and err <= 1e-3
        rows.append((name, ok))
        print(f"[zoo] {name}: {n_params} parameters, {side}x{side}; bf16 train step b{batch} "
              f"loss {loss}; f32 eval logits (b{eval_batch}) card vs CPU: max diff / max "
              f"{err} (limit 1e-3); {time.perf_counter() - t0} s")
        del weights, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bad = [n for n, ok in rows if not ok]
    print(f"[zoo] {len(rows)} archs, worst card-vs-CPU logits {worst}; card {card}")
    if bad:
        raise SystemExit(f"zoo archs failed (non-finite loss or eval logits off): {bad}")


def zoo_representatives(dev, card, root, reps=ZOO_REPRESENTATIVES, steps=3, timed=3):
    """Each representative through ``recipes.tpu_native`` at full size, bf16,
    synthetic: ``steps`` train steps and one eval batch (finite losses), then
    the train step alone on one device batch, 1 warm-up and the median of
    ``timed`` synchronised steps.  Returns ``{name: (step_ms, images_s)}``."""
    out = {}
    for name, side, batch in reps:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = tpu_native.run([
                "-a", name, "--synthetic", "-b", str(batch), "--image-size", str(side),
                "--synthetic-length", str(steps * batch), "--epochs", "1", "-p", "100",
                "-j", "4", "--seed", "0", "--precision", "bf16", "--num-classes", "1000",
                "--device", dev.type, "--checkpoint-dir", d,
                "--epoch-csv", os.path.join(d, "e.csv")])
        run_s = time.perf_counter() - t0
        losses = [float(x) for x in trainer.losses]
        g = torch.Generator(device=dev).manual_seed(1)
        b = {"images": torch.randn(batch, side, side, 3, device=dev, generator=g),
             "labels": torch.randint(0, 1000, (batch,), device=dev, generator=g),
             "weights": torch.ones(batch, device=dev)}
        times = []
        for _ in range(1 + timed):
            t1 = time.perf_counter()
            trainer.train_step(b, 0.01)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        ms = statistics.median(times[1:])
        mem = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
        out[name] = (ms, batch / ms * 1e3)
        # Eval runs on running statistics 3 EMA steps old, so a deep net's
        # eval loss may overflow (JAX's EMA does the same); it must have run.
        ok = (len(losses) == steps and all(math.isfinite(x) for x in losses)
              and len(trainer.eval_history) == 1)
        print(f"[zoo] tpu_native -a {name} b{batch} {side}x{side} bf16: losses {losses}, eval "
              f"{list(trainer.eval_history[0])}, run {run_s} s; train step median of {timed} "
              f"{ms} ms (all {times}), {batch / ms * 1e3} images/s, peak {mem} GiB; "
              f"card {card}")
        del trainer, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if not ok:
            raise SystemExit(f"tpu_native -a {name}: losses or eval not finite")
    return out


# Phase 21's chaos probe: one rank against itself with every image scaled
# by this factor, at the lr the check first ran at.
ZOO_PROBE_SCALE = 1.0000001


def zoo_world_invariance(card, root, steps=1, batch=128, lr=0.01, probe_lr=0.1):
    """``multiprocessing_distributed -a mobilenet_v2`` (BatchNorm and
    dropout) at 2 gloo ranks of ``batch // 2`` on the one card against 1
    rank of ``batch`` over NCCL, f32, TF32 off, ``steps`` steps at ``lr``:
    the sound run within phase 16's ``WORLD_*`` limits (loss and weights),
    and each control outside at least one of them: per-rank BatchNorm, and
    DDP's hook returning this rank's gradient unsummed.  Beside them the
    chaos probe: 1 rank at ``probe_lr`` with the images scaled by
    ``ZOO_PROBE_SCALE`` against the same rank unscaled, whose largest weight
    difference is what rounding-sized perturbations alone move: at lr 0.1
    it moved the first conv's weights by 8.05e-4, more than the 2-rank run
    (6.37e-4) and past the 3.5e-4 limit (PERF.md §2), so the check steps at
    lr 0.01, where both are ten times smaller.  All the processes share the
    card at once."""
    def args(rate):
        return ["-a", "mobilenet_v2", "--synthetic", "-b", str(batch), "--image-size", "224",
                "--synthetic-length", str(steps * batch), "--epochs", "1", "--seed", "0",
                "-p", "1", "-j", "4", "--precision", "fp32", "--lr", str(rate)]

    # tag -> (world, worker flags, lr)
    runs = {"world 1": (1, (), lr), "sound": (2, (), lr),
            "control: per-rank BatchNorm": (2, ("--per-rank-bn",), lr),
            "control: no gradient sum": (2, ("--no-grad-sum",), lr),
            "probe": (1, (f"--scale-images={ZOO_PROBE_SCALE}",), probe_lr)}
    if probe_lr != lr:
        runs["probe reference"] = (1, (), probe_lr)
    outs, procs = {}, []
    for i, (tag, (world, flags, rate)) in enumerate(runs.items()):
        out = outs[tag] = os.path.join(root, f"zoo_world_{i}")
        a = args(rate) + ["--checkpoint-dir", os.path.join(out, "ckpt")]
        port = _free_port()
        procs += [_launch("multiprocessing_distributed", out, a, ("--tf32-off", *flags),
                          {"PTD_TPU_COORDINATOR": f"127.0.0.1:{port}",
                           **({"PTD_TPU_NUM_PROCESSES": "2", "PTD_TPU_PROCESS_ID": str(r)}
                              if world == 2 else {})})
                  for r in range(world)]
    t0 = time.perf_counter()
    _wait(procs, "multiprocessing_distributed -a mobilenet_v2 (world 1, world 2, controls, "
          "probe)")
    wall = time.perf_counter() - t0
    res, state = {}, {}
    for tag, (world, _, _) in runs.items():
        res[tag] = []
        for r in range(world):
            with open(os.path.join(outs[tag], f"result{r}.json")) as f:
                res[tag].append(json.load(f))
        state[tag] = torch.load(os.path.join(outs[tag], "state.pt"))

    def against(tag, ref):
        loss_rel = max(abs(x - y) / abs(y)
                       for x, y in zip(res[tag][0]["losses"], res[ref][0]["losses"]))
        worst, at = max(((state[tag][k].float() - v.float()).abs().max().item(), k)
                        for k, v in state[ref].items())
        return loss_rel, worst, at

    failed = []
    r1 = res["world 1"][0]
    for tag in ("sound", "control: per-rank BatchNorm", "control: no gradient sum"):
        loss_rel, worst, at = against(tag, "world 1")
        r2 = res[tag]
        within = loss_rel <= WORLD_LOSS_REL and worst <= WORLD_WEIGHT_ABS
        print(f"[zoo] world invariance ({tag}), mobilenet_v2 f32 TF32 off, lr {lr}, {steps} "
              f"steps: 2 ranks x b{batch // 2} over {r2[0]['backend']} vs 1 rank x b{batch} "
              f"over {r1['backend']} (all {len(procs)} processes side by side: {wall} s): "
              f"losses {r2[0]['losses']} vs {r1['losses']} (max rel {loss_rel}, limit "
              f"{WORLD_LOSS_REL}); rank losses equal {r2[0]['losses'] == r2[1]['losses']}; "
              f"weights and statistics max abs diff {worst} at {at} (limit "
              f"{WORLD_WEIGHT_ABS}); K4/K5 launches {r1['launches']} / {r2[0]['launches']}; "
              f"peak {[r['peak_gib'] for r in r2]} GiB; within the limits: {within}; "
              f"card {card}")
        if not (r1["backend"] == "nccl" and r2[0]["backend"] == "gloo"
                and r1["launches"] == r2[0]["launches"] == r2[1]["launches"] == [0, 0]):
            raise SystemExit(f"mobilenet_v2 ({tag}): backend or launches wrong")
        if tag == "sound" and not (within and r2[0]["losses"] == r2[1]["losses"]):
            failed.append("mobilenet_v2 at world 2 does not match world 1")
        if tag != "sound" and within:
            failed.append(f"the mobilenet_v2 world-invariance check cannot see its {tag}")
    ref = "probe reference" if probe_lr != lr else "world 1"
    loss_rel, worst, at = against("probe", ref)
    print(f"[zoo] chaos probe, mobilenet_v2 f32 TF32 off, lr {probe_lr}, {steps} steps, 1 rank "
          f"x b{batch}: images x {ZOO_PROBE_SCALE} vs x 1: losses max rel {loss_rel}; weights "
          f"and statistics max abs diff {worst} at {at}; card {card}")
    if failed:
        raise SystemExit("; ".join(failed))


def zoo_phase(dev, card):
    """Phase 21: the sweep of every zoo arch, the six representatives through
    ``tpu_native``, and MobileNetV2's world invariance; none of K1-K5 may
    launch."""
    for k in KERNEL_WRAPPERS:
        k.launches = 0
    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        t0 = time.perf_counter()
        zoo_sweep(dev, card)
        t1 = time.perf_counter()
        zoo_representatives(dev, card, root)
        t2 = time.perf_counter()
        zoo_world_invariance(card, root)
        print(f"[time] phase 21: sweep {t1 - t0} s, representatives {t2 - t1} s, world "
              f"invariance {time.perf_counter() - t2} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launched = [k.launches for k in KERNEL_WRAPPERS]
    print(f"[zoo] kernel launches K1-K5 during phase 21: {launched}")
    if any(launched):
        raise SystemExit(f"a kernel of K1-K5 launched on the zoo path: {launched}")


# Phase 22's limits on 2 gloo ranks sharing the card against 1 rank (f32,
# TF32 off, 3 steps): the largest relative difference of a step's loss and
# the largest absolute difference of any weight after the last step, each
# set between the sound runs and the controls that must exceed it (PERF.md
# §2).
LM_WORLD_LOSS_REL = 1e-5
LM_WORLD_WEIGHT_ABS = 1e-4
LM_MESH_CASES = {   # name: (dp, tp, fsdp, zero, global batch, control)
    "dp2": (2, 1, False, "none", 4, None),
    "tp2": (1, 2, False, "none", 2, None),
    "fsdp2": (2, 1, True, "none", 4, None),
    "wus2": (2, 1, False, "wus", 4, None),
    "tp2_contiguous_qkv": (1, 2, False, "none", 2, "contiguous_qkv"),
    "dp2_no_grad_sum": (2, 1, False, "none", 4, "no_grad_sum"),
}


def _lm_mesh_cfg(cfg):
    """Phase 22's 2-rank model: the LM cell's width, depth cut to 2."""
    return dict(cfg, n_layers=2)


def _lm_tokens(cfg, B, TL, steps):
    from pytorch_distributed_tpu_torch.train.lm import SyntheticTokenDataset

    ds = SyntheticTokenDataset(64, TL, cfg["vocab_size"], seed=0)
    return [torch.from_numpy(ds.batch(i, B)) for i in range(steps)]


def lm_mesh_worker(argv) -> int:
    """``--lm-mesh-worker OUT``: one of phase 22's two gloo ranks sharing the
    card.  Runs every case of ``LM_MESH_CASES`` over one process group (f32,
    TF32 off, the LM width at 2 layers, L=4096, 3 steps), each from the
    seed's weights, and writes ``OUT/mesh<rank>.pt``: per case the losses,
    K1-K3 launches, resident parameter and momentum bytes and (rank 0) the
    whole model gathered after the last step."""
    from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
    from pytorch_distributed_tpu_torch.parallel import tp as tp_lib
    from pytorch_distributed_tpu_torch.parallel.fsdp import apply_fsdp
    from pytorch_distributed_tpu_torch.parallel.mesh import MeshSpec, build_mesh, device_for
    from pytorch_distributed_tpu_torch.train import lm

    out = argv[0]
    TL, steps = int(argv[1]), int(argv[2])
    cfg = _lm_mesh_cfg(json.loads(argv[3]))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = initialize(device="cuda")
    dev = device_for(ctx, "cuda")
    res = {"backend": ctx.backend, "world": ctx.process_count}
    real_sync = lm._sync_data
    for name, (dp, tp, fsdp, zero, B, control) in LM_MESH_CASES.items():
        mesh = build_mesh(MeshSpec(("data", "model"), (dp, tp)), ctx)
        model = TransformerLM(**cfg, dtype=torch.float32, device=dev, mesh=mesh)
        if control == "contiguous_qkv":   # a contiguous half of qkv's rows: not a head group
            for k in model.specs:
                if k.endswith("attn.qkv.weight"):
                    model.specs[k] = tp_lib._contiguous(3 * cfg["d_model"], tp, 0)
        if fsdp:
            apply_fsdp(model, mesh)
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
        lm._sync_data = (lambda params, group: None) if control == "no_grad_sum" else real_sync
        opt = sgd(model.parameters())
        step = lm.make_lm_train_step(model, opt, zero=zero, mesh=mesh)
        for k in KERNEL_WRAPPERS[:3]:
            k.launches = 0
        d = mesh.index("data")
        losses = []
        for toks in _lm_tokens(cfg, B, TL, steps):
            losses.append(float(step(toks[d * B // dp:(d + 1) * B // dp].to(dev), 1e-2)["loss"]))
        torch.cuda.synchronize()
        launches = [k.launches for k in KERNEL_WRAPPERS[:3]]
        full = model.full_state_dict()
        res[name] = {"losses": losses, "launches": launches,
                     "param_bytes": _param_bytes(model),
                     "momentum_bytes": gradsync.momentum_bytes(opt, step.comm),
                     "state": ({k: v.detach().cpu() for k, v in full.items()}
                               if mesh.is_primary else None)}
        del model, opt, step, full
        torch.cuda.empty_cache()
    lm._sync_data = real_sync
    torch.save(res, os.path.join(out, f"mesh{ctx.process_index}.pt"))
    shutdown(ctx)
    return 0


def lm_worker(argv) -> int:
    """``--lm-worker OUT -- ARGS``: ``lm_pretrain.run(ARGS)`` in a process of
    its own (under a launcher's environment), K1-K3 counted over the run;
    writes ``OUT/lm.json`` and the final weights ``OUT/state.pt``."""
    out, args = argv[0], argv[argv.index("--") + 1:]
    for k in KERNEL_WRAPPERS[:3]:
        k.launches = 0
    trainer = lm_pretrain.run(args)
    torch.cuda.synchronize()
    res = {"backend": trainer.ctx.backend, "world": trainer.ctx.process_count,
           "mesh": trainer.mesh.shape, "launches": [k.launches for k in KERNEL_WRAPPERS[:3]],
           "losses": [float(x) for x in trainer.losses],
           "step_ms": [t * 1e3 for t in trainer.step_times]}
    torch.save({k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
               os.path.join(out, "state.pt"))
    with open(os.path.join(out, "lm.json"), "w") as f:
        json.dump(res, f)
    from pytorch_distributed_tpu_torch.parallel import shutdown
    shutdown(trainer.ctx)
    return 0


def _spawn(args, env, out, log):
    """A process of ``args`` in a clean launcher environment plus ``env``,
    its output to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *args], env=_clean_env(env), cwd=out,
                                stdout=f, stderr=subprocess.STDOUT, text=True)


def _wait_logs(procs, logs, what, timeout=600):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            with open(log) as f:
                raise SystemExit(f"{what} exited {p.returncode}:\n{f.read()[-4000:]}")


def lm_mesh_phase(dev, card, cfg, lm_unfused_ms, TB=4, TL=4096, steps=3, gen_new=16):
    """Phase 22: LM training across ranks and ``lm_generate --tp``.  Returns
    the (K1, K2, K3) launches of its training runs."""
    here = os.path.abspath(__file__)
    root = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    args = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
            "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
            "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision", "bf16",
            "--no-eval", "-p", str(steps)]
    total = [0, 0, 0]
    try:
        # (a) lm_pretrain through the launcher at world 1 (NCCL), alone on
        # the card for its step times, then without a group in this process.
        t0 = time.perf_counter()
        out = os.path.join(root, "nccl")
        os.makedirs(out)
        log = os.path.join(out, "log")
        _wait_logs([_spawn([here, "--lm-worker", out, "--", *args],
                           {"PTD_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                            "PTD_TPU_NUM_PROCESSES": "1", "PTD_TPU_PROCESS_ID": "0"}, out, log)],
                   [log], "lm_pretrain at world 1")
        with open(os.path.join(out, "lm.json")) as f:
            nccl = json.load(f)
        t_a = time.perf_counter() - t0

        # (b) the 2-rank cases and (c) lm_generate --tp 2, four processes
        # sharing the card, while this process runs the references.
        t0 = time.perf_counter()
        procs, logs = [], []
        mesh_out = os.path.join(root, "mesh")
        os.makedirs(mesh_out)
        port, gport = _free_port(), _free_port()
        prompt = [(7 * i + 3) % cfg["vocab_size"] for i in range(16)]
        gen_args = ["-m", "pytorch_distributed_tpu_torch.recipes.lm_generate", "--random-init",
                    "--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
                    "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
                    "--prompt-tokens", ",".join(map(str, prompt)), "-n", str(gen_new),
                    "--precision", "fp32", "--tp", "2"]
        for r in range(2):
            env = {"PTD_TPU_NUM_PROCESSES": "2", "PTD_TPU_PROCESS_ID": str(r)}
            logs.append(os.path.join(mesh_out, f"log{r}"))
            procs.append(_spawn([here, "--lm-mesh-worker", mesh_out, str(TL), str(steps),
                                 json.dumps(cfg)],
                                {**env, "PTD_TPU_COORDINATOR": f"127.0.0.1:{port}"},
                                mesh_out, logs[-1]))
            logs.append(os.path.join(mesh_out, f"gen{r}"))
            procs.append(_spawn(gen_args, {**env, "PTD_TPU_COORDINATOR": f"127.0.0.1:{gport}"},
                                mesh_out, logs[-1]))
        for k in KERNEL_WRAPPERS[:3]:
            k.launches = 0
        trainer = lm_pretrain.run([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        plain = [k.launches for k in KERNEL_WRAPPERS[:3]]
        same = (nccl["losses"] == [float(x) for x in trainer.losses]
                and all(torch.equal(v.cpu(), w) for v, w in
                        zip(trainer.model.state_dict().values(),
                            torch.load(os.path.join(out, "state.pt")).values())))
        nccl_ms = statistics.median(nccl["step_ms"][1:])
        print(f"[lm-mesh] lm_pretrain at world 1 over {nccl['backend']} (mesh {nccl['mesh']}) "
              f"vs no group, bf16 B={TB} L={TL} {cfg['n_layers']} layers, {steps} steps: "
              f"{'bitwise equal' if same else 'DIFFERENT'}, losses {nccl['losses']}; step "
              f"{nccl_ms} ms (median of steps 2-{steps}; all {nccl['step_ms']}) vs phase 17's "
              f"unfused step {lm_unfused_ms} ms; launches K1/K2/K3 {nccl['launches']} and "
              f"{plain}; card {card}")
        want = [cfg["n_layers"] * steps] * 3
        if not (same and nccl["backend"] == "nccl" and nccl["launches"] == want
                and plain == want):
            raise SystemExit("lm_pretrain at world 1 over NCCL is not the run without a group, "
                             "or K1-K3 did not launch once per layer per step")
        total = [a + b + c for a, b, c in zip(total, nccl["launches"], plain)]
        del trainer
        torch.cuda.empty_cache()

        # The 1-rank references of (b), f32, TF32 off, in this process.
        from pytorch_distributed_tpu_torch.train import lm as lm_mod

        mcfg = _lm_mesh_cfg(cfg)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        refs = {}
        for B in (TB, TB // 2):
            model = TransformerLM(**mcfg, dtype=torch.float32, device=dev)
            model.init_weights(torch.Generator(device=dev).manual_seed(0))
            step = lm_mod.make_lm_train_step(model, sgd(model.parameters()))
            losses = [float(step(t.to(dev), 1e-2)["loss"]) for t in _lm_tokens(mcfg, B, TL,
                                                                                 steps)]
            refs[B] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()})
            del model, step
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = tf32

        # (c)'s reference: --tp 1 on the same weights and prompt.
        gmodel = TransformerLM(**cfg, dtype=torch.float32, device=dev)
        gmodel.init_weights(torch.Generator(device=dev).manual_seed(0))
        gprompt = torch.tensor([prompt], device=dev)
        gwant = generate(gmodel, gprompt, gen_new)
        _wait_logs(procs, logs, "phase 22's 2-rank processes")
        t_bc = time.perf_counter() - t0

        ranks = [torch.load(os.path.join(mesh_out, f"mesh{r}.pt")) for r in range(2)]
        readings = {}
        for name, (dp, tp, fsdp, zero, B, control) in LM_MESH_CASES.items():
            got = ranks[0][name]
            ref_losses, ref_state = refs[B]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref_losses))
            w_abs = max((got["state"][k] - v).abs().max().item() for k, v in ref_state.items())
            readings[name] = (loss_rel, w_abs)
            kl = [a + b for a, b in zip(ranks[0][name]["launches"], ranks[1][name]["launches"])]
            sound = control is None
            inside = loss_rel <= LM_WORLD_LOSS_REL and w_abs <= LM_WORLD_WEIGHT_ABS
            print(f"[lm-mesh] {name} ({'sound' if sound else 'control: ' + control}), "
                  f"dp {dp} x tp {tp}{' fsdp' if fsdp else ''}{' zero wus' if zero != 'none' else ''}"
                  f", 2 gloo ranks on one card vs 1 rank, f32 TF32 off, {mcfg['n_layers']} layers "
                  f"at the LM width, B={B} L={TL}, {steps} steps: losses {got['losses']} vs "
                  f"{ref_losses} (max rel {loss_rel}, limit {LM_WORLD_LOSS_REL}); weights max "
                  f"abs diff {w_abs} (limit {LM_WORLD_WEIGHT_ABS}); launches K1/K2/K3 of both "
                  f"ranks {kl}; resident parameter / momentum bytes per rank "
                  f"{[ranks[r][name]['param_bytes'] for r in range(2)]} / "
                  f"{[ranks[r][name]['momentum_bytes'] for r in range(2)]}; card {card}")
            if sound != inside:
                raise SystemExit(f"{name}: {'outside' if sound else 'inside'} the 2-rank limits")
            if sound:
                if kl != [2 * mcfg["n_layers"] * steps] * 3:
                    raise SystemExit(f"{name}: K1-K3 launched {kl} times")
                total = [a + b for a, b in zip(total, kl)]
        dp_b = ranks[0]["dp2"]["param_bytes"] + ranks[0]["dp2"]["momentum_bytes"]
        fs_b = ranks[0]["fsdp2"]["param_bytes"] + ranks[0]["fsdp2"]["momentum_bytes"]
        print(f"[lm-mesh] resident parameter + momentum bytes per rank: FSDP 2 {fs_b} vs DP 2 "
              f"{dp_b} ({fs_b / dp_b}); card {card}")
        if not fs_b < 0.55 * dp_b:
            raise SystemExit("FSDP 2 holds more than 0.55 of DP 2's bytes per rank")

        text = open(logs[1]).read()
        line = [l for l in text.splitlines() if l.startswith("tokens:")]
        if len(line) != 1 or "tokens:" in open(logs[3]).read():
            raise SystemExit(f"lm_generate --tp 2: rank 0 must print the tokens once:\n{text}")
        got = torch.tensor([json.loads(line[0].split(":", 1)[1])], device=dev)
        compared, gaps = _greedy_rule(gmodel, gprompt, got, gwant, 1e-3,
                                      "lm_generate --tp 2 vs --tp 1")
        print(f"[lm-mesh] lm_generate --tp 2 (2 gloo ranks, 8 heads each, dense prefill) vs "
              f"--tp 1, f32, {cfg['n_layers']} layers at the LM width, {len(prompt)}-token "
              f"prompt, {gen_new} new tokens: {compared} of {gen_new} tokens equal before the "
              f"first difference, top-2 gaps there {gaps}; card {card}")
        del gmodel
        print(f"[time] phase 22: world 1 {t_a} s, the 2-rank processes with the references "
              f"{t_bc} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return total


# Phase 23: the training metrics stream (ROADMAP A12's first slice) through
# both trainers at full width with every flag of the slice.  The attribution
# identity's reconciliation error is fenced at the JAX package's 0.5% of the
# step; the synthetic ResNet-50 step is device-bound (PERF.md: 202.03 ms busy
# of 208.80), so its step-attribution compute share must reach 90%.
OBS_RECON_FRAC = 0.005
OBS_COMPUTE_SHARE = 90.0
OBS_TRACE_KERNELS = ("dgrad1_mma_kernel", "wgrad1_mma_kernel", "dgrad3_mma_kernel",
                     "wgrad3_mma_kernel")


def _obs_run(what, fn, argv, **kw):
    """``fn(argv, **kw)`` with its output captured; returns (trainer or
    value, output, wall seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = fn(argv, **kw)
    torch.cuda.synchronize()
    return got, buf.getvalue(), time.perf_counter() - t0


def _obs_records(what, d, trainer, steps, peak, card):
    """The checks both runs share: one record per step, MFU fields, the peak,
    the identity, one heartbeat file at the last step, the goodput line.
    Returns (step records, attribution summary)."""
    from pytorch_distributed_tpu_torch.obs import heartbeat, metrics, stepattr

    recs = metrics.read_metrics(os.path.join(d, "m.jsonl"))
    rows = [r for r in recs if "ft_event" not in r]
    events = [r["ft_event"] for r in recs if "ft_event" in r]
    bad = []
    if [r["step"] for r in rows] != list(range(steps)) or events != ["stepattr_phases"]:
        bad.append(f"records {[r.get('step') for r in rows]}, events {events}")
    for r in rows:
        if not (all(math.isfinite(r[k]) for k in ("mfu", "hfu", "model_tflops"))
                and 0 < r["mfu"] <= 100 and r["hfu"] >= r["mfu"]):
            bad.append(f"step {r['step']}: mfu {r['mfu']} hfu {r['hfu']}")
        if r["attr_recon_err_ms"] > OBS_RECON_FRAC * r["step_time"] * 1e3:
            bad.append(f"step {r['step']}: recon err {r['attr_recon_err_ms']} ms")
    if trainer.ro.mfu.peak != peak:
        bad.append(f"peak {trainer.ro.mfu.peak}, not {peak}")
    beats = heartbeat.read_heartbeats(os.path.join(d, "hb"))
    if len(os.listdir(os.path.join(d, "hb"))) != 1 or beats.get(0, {}).get("step") != steps - 1:
        bad.append(f"heartbeats {beats}")
    if trainer.ro.goodput.report().steps != steps:
        bad.append("goodput")
    summary = stepattr.summarize(recs)
    parts = [tuple(r[f"attr_{c}_ms"] for c in ("compute", "data_wait", "host_sync", "other"))
             for r in rows]
    print(f"[obs] {what}: {steps} records; mfu {[r['mfu'] for r in rows]} %, hfu "
          f"{[r['hfu'] for r in rows]} %, model TFLOP/s {[r['model_tflops'] for r in rows]} "
          f"(peak {trainer.ro.mfu.peak / 1e12} TFLOP/s); attribution: "
          f"{stepattr.format_summary_line(summary)}; per step (compute, data wait, host "
          f"sync, other) ms {parts}; recon err max "
          f"{summary['recon_err_ms_max']} ms; heartbeat {beats.get(0)}; "
          f"{trainer.ro.goodput.format_summary()}; card {card}")
    if bad:
        raise SystemExit(f"phase 23 {what}: " + "; ".join(bad))
    return rows, summary


def obs_phase(dev, card, cfg, steps=16, TB=4, TL=4096, keep=None):
    """Phase 23: ``tpu_native -a resnet50 --fused-convbn`` (b256 224x224 bf16,
    synthetic) and ``lm_pretrain`` at the LM's full width (L 4096, B 4,
    bf16), ``steps`` steps each, first without the slice's flags, then with
    ``--metrics-jsonl --hb-dir --mfu --goodput --step-attr`` (and, for the
    image run, ``--telemetry-csv --profile-dir --profile-steps 2:3``), the
    launch counters zeroed just before each flagged run and read just after
    (the LM's token batches come from the trainer's feeder thread, its
    default ``prefetch=2``).
    Checks the records, MFU against the card's 989 TFLOP/s, the
    attribution identity, the image step's compute share, heartbeats,
    telemetry rows against the card's memory, the trace's kernels and span;
    prints the median step with the flags against without.  Sixteen steps,
    so that the attribution's p50 is not a step the profiler touched: its
    start costs step 2 and its stop and export step 3 (as in the JAX
    trainer, the window opens and closes at the top of a step), and the
    first step warms up.  The image steps took 300-850 ms of device window
    on an H100 80GB HBM3 at 700 W while the loader's threads still built
    synthetic batches on the host and ~207 ms once they were done (the last
    three; PERF.md §5), so both medians are printed.  Returns the (K1, K2, K3, K4, K5)
    launches of its runs and, per run, the (median, last-3 median) step without the flags
    in ms.  ``keep``: a directory the flagged runs' JSONL, heartbeats and telemetry CSV are
    copied to (``{image,lm}_m.jsonl``, ``{image,lm}_hb``, ``image_t.csv``) for phase 26's
    report."""
    from pytorch_distributed_tpu_torch.obs import flops

    peak = flops.device_peak_flops(dev)
    if peak != 989e12:
        raise SystemExit(f"device_peak_flops gave {peak} for {torch.cuda.get_device_name(dev)},"
                         " not the H100's 989e12")
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    launched = [0] * 5
    try:
        image = ["-a", "resnet50", "--synthetic", "--fused-convbn", "-b", "256",
                 "--image-size", "224", "--synthetic-length", str(256 * steps), "--epochs", "1",
                 "--precision", "bf16", "--seed", "0", "-p", "100", "--device", "cuda"]
        lm = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
              "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
              "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision",
              "bf16", "--no-eval", "-p", "100", "--device", "cuda"]
        medians = {}
        for what, fn, base in (("image", tpu_native.run, image), ("lm", lm_pretrain.run, lm)):
            for flagged in (False, True):
                d = os.path.join(root, f"{what}_{int(flagged)}")
                os.makedirs(d)
                argv = list(base)
                if what == "image":
                    argv += ["--checkpoint-dir", os.path.join(d, "ck"), "--epoch-csv",
                             os.path.join(d, "e.csv")]
                if flagged:
                    argv += ["--metrics-jsonl", os.path.join(d, "m.jsonl"), "--hb-dir",
                             os.path.join(d, "hb"), "--mfu", "--goodput", "--step-attr"]
                    if what == "image":
                        argv += ["--telemetry-csv", os.path.join(d, "t.csv"), "--profile-dir",
                                 os.path.join(d, "prof"), "--profile-steps", "2:3"]
                for k in KERNEL_WRAPPERS:
                    k.launches = 0
                trainer, out, wall = _obs_run(what, fn, argv)
                counts = [k.launches for k in KERNEL_WRAPPERS]
                launched = [a + b for a, b in zip(launched, counts)]
                medians[what, flagged] = (statistics.median(trainer.step_times[1:]) * 1e3,
                                          statistics.median(trainer.step_times[-3:]) * 1e3)
                want = ([0, 0, 0, 33 * steps, 13 * steps] if what == "image" else
                        [cfg["n_layers"] * steps] * 3 + [0, 0])
                if counts != want or len(trainer.losses) != steps or not all(
                        math.isfinite(float(x)) for x in trainer.losses):
                    raise SystemExit(f"phase 23 {what} (flags {flagged}): launches {counts}, "
                                     f"expected {want}; losses {trainer.losses}")
                print(f"[obs] {what} {'with' if flagged else 'without'} the flags: steps "
                      f"{[t * 1e3 for t in trainer.step_times]} ms, launches K1-K5 {counts}, "
                      f"run {wall} s")
                if not flagged:
                    del trainer
                    torch.cuda.empty_cache()
                    continue
                if "=> goodput " not in out:
                    raise SystemExit(f"phase 23 {what}: no goodput summary printed")
                rows, summary = _obs_records(what, d, trainer, steps, peak, card)
                if keep is not None:
                    shutil.copy(os.path.join(d, "m.jsonl"), os.path.join(keep, f"{what}_m.jsonl"))
                    shutil.copytree(os.path.join(d, "hb"), os.path.join(keep, f"{what}_hb"))
                    if what == "image":
                        shutil.copy(os.path.join(d, "t.csv"), os.path.join(keep, "image_t.csv"))
                if what == "image":
                    share = summary["shares_pct"]["compute"]
                    total = torch.cuda.get_device_properties(dev).total_memory
                    with open(os.path.join(d, "t.csv")) as f:
                        tele = [[float(x) for x in line.split(",")] for line in f]
                    traces = os.listdir(os.path.join(d, "prof"))
                    with open(os.path.join(d, "prof", traces[0])) as f:
                        text = f.read()
                    names = {n: n in text for n in OBS_TRACE_KERNELS + ('"train_step"',)}
                    print(f"[obs] image: compute share of the step p50 {share} % (limit "
                          f"{OBS_COMPUTE_SHARE}); {len(tele)} telemetry rows, first {tele[0]}, "
                          f"last {tele[-1]} (card total {total}); trace {traces} "
                          f"({len(text)} bytes) names {names}")
                    if share < OBS_COMPUTE_SHARE:
                        raise SystemExit(f"phase 23 image: compute share {share} %")
                    if not tele or not all(r[2] == total and r[4] >= r[3] > 0 for r in tele):
                        raise SystemExit(f"phase 23 image: telemetry rows {tele}")
                    if len(traces) != 1 or not all(names.values()):
                        raise SystemExit(f"phase 23 image: trace {traces}, names {names}")
                del trainer
                torch.cuda.empty_cache()
        # The host's share of an LM step: one token batch (TB x TL) built
        # anew on the host, as the feeder thread builds each step's.
        ds = SyntheticTokenDataset(64, TL, cfg["vocab_size"], seed=1)
        builds = []
        for s in range(5):
            t0 = time.perf_counter()
            ds.batch(s, TB)
            builds.append((time.perf_counter() - t0) * 1e3)
        print(f"[obs] lm: one host token batch ({TB} x {TL}) built in {builds} ms, median "
              f"{statistics.median(builds)} ms; card {card}")
        for what in ("image", "lm"):
            (on, on_tail), (off, off_tail) = medians[what, True], medians[what, False]
            print(f"[obs] {what}: median step (steps 2-{steps}) with the flags {on} ms vs "
                  f"without {off} ms: {100 * (on - off) / off} %; of the last 3 steps (the "
                  f"loader's threads done) {on_tail} vs {off_tail} ms: "
                  f"{100 * (on_tail - off_tail) / off_tail} %"
                  + ("; the LM's token batches now come from the trainer's feeder thread "
                     "(prefetch 2); built in the loop they read +11.6 % (H100 80GB HBM3, "
                     "700.00 W; PERF.md §6)" if what == "lm" else "") + f"; card {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launched, {what: medians[what, False] for what in ("image", "lm")}


# Phase 24: the run's death paths and live plane (ROADMAP A12's second slice,
# with A11's preemption guard and chaos hooks).  (c) is the JAX package's
# two-process hang story (tests/test_flightrec.py's LateRank): rank 1 stalls
# before its step-3 collective, then SIGTERMs itself; rank 0 blocks inside
# the step-3 gradient all-reduce (gloo blocks the host there) and its
# watchdog dumps; the guard's agreement stops both at the next poll.
LIVE_SCRAPE_S = 0.5
FT_STALL_STEP, FT_STALL_S, FT_BATCH, FT_PRINT_FREQ = 3, 4.0, 4, 2
FT_HANG_FLOOR_S = 1.0   # rank 0's watchdog floor after step 0
FT_STOP_STEP = 4   # the first agreement poll (every FT_PRINT_FREQ steps) after the signal


class _Scraper(threading.Thread):
    """Reads ``/metrics`` and ``/healthz`` of one exporter every
    ``LIVE_SCRAPE_S`` while a run goes; ``reads`` holds (samples, healthz
    status) of each answered scrape (none before the exporter binds or
    after it stops)."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.done = threading.Event()
        self.reads: list = []

    def run(self):
        import urllib.error
        import urllib.request

        from pytorch_distributed_tpu_torch.obs.export import parse_prometheus

        while not self.done.is_set():
            try:
                with urllib.request.urlopen(self.base + "/metrics", timeout=2.0) as r:
                    samples = parse_prometheus(r.read().decode())
                try:
                    with urllib.request.urlopen(self.base + "/healthz", timeout=2.0) as r:
                        health = r.status
                except urllib.error.HTTPError as e:
                    health = e.code
                self.reads.append((samples, health))
            except OSError:
                pass  # not serving yet, or stopped
            self.done.wait(LIVE_SCRAPE_S)

    def stop(self) -> list:
        self.done.set()
        self.join(timeout=10)
        return self.reads


def _flush_each_record(trainer):
    """The run's own hub drains every record as it is logged, so a 16-step
    run's exporter serves each step live (the default cadence, 50, would
    hold them all until the end; the JAX package's chaos drills set
    ``obs.flush_every = 1`` on their trainers for the same reason).  Each
    flush converts the step's device scalars: one synchronize a step."""
    trainer.ro.obs.flush_every = 1


def _live_checks(what, d, trainer, reads, steps):
    """(a)/(b)'s misses: scrapes, their losses against the records, healthz,
    alerts, the watchdog, dumps."""
    from pytorch_distributed_tpu_torch.obs import metrics
    from pytorch_distributed_tpu_torch.obs.export import sample_value
    from pytorch_distributed_tpu_torch.obs.flightrec import find_dumps

    recs = metrics.read_metrics(os.path.join(d, "m.jsonl"))
    loss_at = {r["step"]: r["loss"] for r in recs if "ft_event" not in r}
    up = [(sample_value(smp, "ptd_up", rank=0), sample_value(smp, "ptd_step", rank=0), h)
          for smp, h in reads]
    live = [(st, h) for u, st, h in up if u == 1.0 and st is not None]
    seen = [st for st, _ in live]
    bad = []
    if len(live) < 2 or seen != sorted(seen) or seen[-1] <= seen[0]:
        bad.append(f"scrapes with ptd_up 1 and a step: {seen}")
    for smp, _ in reads:
        st = sample_value(smp, "ptd_step", rank=0)
        if st is None:
            continue
        got = sample_value(smp, "ptd_metric", rank=0, field="loss")
        # The exposition prints 6 significant digits (%g, the JAX rendering).
        if got != float(f"{loss_at.get(int(st), float('nan')):g}"):
            bad.append(f"step {st}: scraped loss {got}, record {loss_at.get(int(st))}")
        if any(n == "ptd_alert_firing" for n, _, _ in smp):
            bad.append(f"step {st}: an alert is firing")
    if not live or any(h != 200 for _, h in live):
        bad.append(f"healthz after a record: {[h for _, h in live]}")
    events = [r["ft_event"] for r in recs if "ft_event" in r]
    hangs = trainer.ro.hang_wd.hangs
    dumps = find_dumps(os.path.join(d, "fr"))
    if "alert" in events or trainer.ro.alerts.history or hangs or dumps:
        bad.append(f"events {events}, alerts {trainer.ro.alerts.history}, hangs {hangs}, "
                   f"dumps {dumps}")
    if sorted(loss_at) != list(range(steps)):
        bad.append(f"records of steps {sorted(loss_at)}")
    last = ([(st, sample_value(smp, "ptd_metric", rank=0, field="loss"))
             for smp, _ in reads if (st := sample_value(smp, "ptd_step", rank=0)) is not None]
            or [(None, None)])[-1]
    print(f"[live] {what}: {len(reads)} scrapes, steps seen live {seen}, healthz "
          f"{[h for _, _, h in up]}, last scraped step {last[0]} loss {last[1]} (its record "
          f"{loss_at.get(int(last[0])) if last[0] is not None else None}), events {events}, "
          f"watchdog hangs {hangs}, dumps {dumps}")
    if bad:
        raise SystemExit(f"phase 24 {what}: " + "; ".join(bad))


def ft_worker(argv) -> int:
    """``--ft-worker OUT L STEPS CFG_JSON``: one of phase 24(c)'s two gloo
    ranks sharing the card (DP 2, the LM width at 2 layers, bf16, B=4,
    L=4096).  Builds its ``LMTrainer`` with a ``PreemptionGuard``, the
    flight recorder, heartbeats (interval 0), metrics JSONL, ``--alerts
    default`` and a checkpoint dir; rank 1's ``on_step`` stalls
    ``FT_STALL_S`` at ``FT_STALL_STEP`` and then SIGTERMs itself; the
    watchdog floors are 300 s, rank 0's ``FT_HANG_FLOOR_S`` from step 1 on.
    Writes ``OUT/ft<rank>.json``."""
    import signal

    from pytorch_distributed_tpu_torch.ft.chaos import ChaosInjector
    from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
    from pytorch_distributed_tpu_torch.parallel.mesh import MeshSpec, build_mesh, device_for
    from pytorch_distributed_tpu_torch.train import lm
    from pytorch_distributed_tpu_torch.utils.preempt import PreemptionGuard

    out, TL, steps = argv[0], int(argv[1]), int(argv[2])
    cfg = _lm_mesh_cfg(json.loads(argv[3]))
    ctx = initialize(device="cuda")
    dev = device_for(ctx, "cuda")
    rank = ctx.process_index

    class LateRank(ChaosInjector):
        # Before the step's flight window: the stalled rank's frontier stays
        # one collective behind its peer's.  Rank 0's floor drops to
        # FT_HANG_FLOOR_S once step 0 is done: step 0 holds the start-up
        # and waits for the later rank's first collective, and must not
        # fire it.
        def on_step(self, trainer, step):
            if rank == 0 and step == 1:
                trainer.ro.hang_wd.timeout = FT_HANG_FLOOR_S
            if rank == 1 and step == FT_STALL_STEP:
                time.sleep(FT_STALL_S)
                os.kill(os.getpid(), signal.SIGTERM)

    mesh = build_mesh(MeshSpec(("data",), (2,)), ctx)
    model = TransformerLM(**cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev,
                          mesh=mesh)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    guard = PreemptionGuard().install()
    for k in KERNEL_WRAPPERS[:3]:
        k.launches = 0
    try:
        t = lm.LMTrainer(model, lm.SyntheticTokenDataset(64, TL, cfg["vocab_size"], seed=0),
                         FT_BATCH, lr=1e-2, mesh=mesh, preempt=guard, chaos=LateRank(),
                         flight_rec=out, hb_dir=out, hb_interval_s=0.0,
                         metrics_jsonl=os.path.join(out, f"m{rank}.jsonl"), alerts="default",
                         checkpoint_dir=os.path.join(out, "ck"), hang_timeout=300.0)
        t.fit(steps, print_freq=FT_PRINT_FREQ)
        torch.cuda.synchronize()
    finally:
        guard.uninstall()
    res = {"backend": ctx.backend, "steps": len(t.losses), "hangs": t.ro.hang_wd.hangs,
           "launches": [k.launches for k in KERNEL_WRAPPERS[:3]],
           "losses": [float(x) for x in t.losses],
           "checkpoints": [step for _, kind, step, _ in t.ro.flight._ring
                           if kind == "checkpoint"]}
    with open(os.path.join(out, f"ft{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown(ctx)
    return 0


def _hang_story(card, cfg, TL=4096, steps=12):
    """Phase 24(c); returns the (K1, K2, K3) launches of both ranks."""
    from pytorch_distributed_tpu_torch.obs import metrics
    from pytorch_distributed_tpu_torch.obs.flightrec import find_dumps
    from pytorch_distributed_tpu_torch.tools import postmortem
    from pytorch_distributed_tpu_torch.train.checkpoint import read_payload

    here = os.path.abspath(__file__)
    out = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        port = _free_port()
        procs, logs = [], []
        for r in range(2):
            logs.append(os.path.join(out, f"log{r}"))
            procs.append(_spawn([here, "--ft-worker", out, str(TL), str(steps), json.dumps(cfg)],
                                {"PTD_TPU_COORDINATOR": f"127.0.0.1:{port}",
                                 "PTD_TPU_NUM_PROCESSES": "2", "PTD_TPU_PROCESS_ID": str(r)},
                                out, logs[-1]))
        _wait_logs(procs, logs, "phase 24(c)'s 2 ranks", timeout=400)
        res = [json.load(open(os.path.join(out, f"ft{r}.json"))) for r in range(2)]
        dumps = find_dumps(out)
        docs = {r: json.load(open(p)) for r, p in dumps.items()}
        report = postmortem.postmortem(out, hb_dir=out)
        ev0 = [r for r in metrics.read_metrics(os.path.join(out, "m0.jsonl")) if "ft_event" in r]
        ckpt_ft = read_payload(os.path.join(out, "ck", CHECKPOINT_NAME))["ft"]
        n_layers = _lm_mesh_cfg(cfg)["n_layers"]
        for r, d in sorted(docs.items()):
            print(f"[live] hang story rank {r} dump: reason {d['reason']}, in_step "
                  f"{d['in_step']}, last_collective {d['last_collective']}, step_times "
                  f"{d['step_times']}, membership {d['membership']}, mem_bytes "
                  f"{d['mem_bytes']}, events {d['events_total']} ({d['events_dropped']} "
                  f"dropped), worker {res[r]}")
        print(f"[live] hang story: rank 0's events {[(e['ft_event'], e.get('step'), e.get('rule')) for e in ev0]}; "
              f"checkpoint ft {ckpt_ft}; postmortem verdict: {report.get('verdict')} "
              f"(stalled_rank {report.get('stalled_rank')}, hang_ranks "
              f"{report.get('hang_ranks')}, frontier_desync {report.get('frontier_desync')}); "
              f"card {card}")
        print(postmortem.render_text(report))
        bad = []
        if sorted(docs) != [0, 1]:
            bad.append(f"dumps {sorted(docs)}")
        else:
            d0, d1 = docs[0], docs[1]
            if not (d0["reason"] == "hang" and (d0["in_step"] or {}).get("step") == FT_STALL_STEP
                    and d0["last_collective"]["step"] == FT_STALL_STEP):
                bad.append("rank 0's dump is not the hang inside step 3")
            if not (d1["reason"] == "signal:15"
                    and d1["last_collective"]["step"] == FT_STALL_STEP - 1):
                bad.append("rank 1's dump is not SIGTERM one collective behind")
        if [x["hangs"] for x in res] != [1, 0]:
            bad.append(f"watchdog hangs {[x['hangs'] for x in res]}")
        if [x["steps"] for x in res] != [FT_STOP_STEP] * 2 or any(
                x["checkpoints"] != [FT_STOP_STEP] for x in res) or \
                (ckpt_ft["step"], ckpt_ft["global_step"]) != (FT_STOP_STEP, FT_STOP_STEP):
            bad.append("the ranks did not stop and checkpoint at the same step")
        # The stall, and only the stall, fired the watchdog and the rule.
        hang_steps = [e.get("step") for e in ev0 if e["ft_event"] == "hang"]
        alerts = [(e.get("rule"), e.get("step")) for e in ev0 if e["ft_event"] == "alert"]
        if hang_steps != [FT_STALL_STEP] or not alerts or any(
                rule != "hang" or st is None or st < FT_STALL_STEP for rule, st in alerts):
            bad.append(f"rank 0's hang events at steps {hang_steps}, alerts {alerts}")
        if not (report.get("stalled_rank") == 1 and report.get("hang_ranks") == [0]
                and report.get("frontier_desync") is True
                and "rank 1 stalled first" in report.get("verdict", "")):
            bad.append("the postmortem does not blame rank 1")
        if any(x["launches"] != [n_layers * FT_STOP_STEP] * 3 for x in res):
            bad.append(f"K1-K3 launches {[x['launches'] for x in res]}")
        if any(x["backend"] != "gloo" for x in res):
            bad.append("not gloo")
        if bad:
            raise SystemExit("phase 24(c): " + "; ".join(bad))
        return [a + b for a, b in zip(res[0]["launches"], res[1]["launches"])]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def live_phase(dev, card, cfg, medians23, steps=16, TB=4, TL=4096):
    """Phase 24: (a) ``lm_pretrain`` at the LM's full width and (b)
    ``tpu_native -a resnet50 --fused-convbn`` (b256, 224x224, bf16,
    synthetic), 16 steps each, with ``--metrics-jsonl --flight-rec
    --hang-timeout 30 --metrics-port P --alerts default`` and the default
    SIGTERM guard, the hub draining every record, a thread scraping
    ``/metrics`` and ``/healthz`` every 0.5 s, the launch counters zeroed
    just before each run and read just after; then (c) the two-rank hang
    story.  Prints each median step against phase 23's run without flags
    (``medians23``).  Returns the (K1, K2, K3, K4, K5) launches."""
    root = tempfile.mkdtemp(prefix="chip_smoke_live_")
    launched = [0] * 5
    try:
        lm = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
              "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
              "--seq-len", str(TL), "-b", str(TB), "--steps", str(steps), "--precision",
              "bf16", "--no-eval", "-p", "100", "--device", "cuda"]
        image = ["-a", "resnet50", "--synthetic", "--fused-convbn", "-b", "256",
                 "--image-size", "224", "--synthetic-length", str(256 * steps), "--epochs", "1",
                 "--precision", "bf16", "--seed", "0", "-p", "100", "--device", "cuda"]
        for what, fn, base in (("lm", lm_pretrain.run, lm), ("image", tpu_native.run, image)):
            d = os.path.join(root, what)
            os.makedirs(d)
            port = _free_port()
            argv = base + ["--metrics-jsonl", os.path.join(d, "m.jsonl"), "--flight-rec",
                           os.path.join(d, "fr"), "--hang-timeout", "30", "--metrics-port",
                           str(port), "--alerts", "default"]
            if what == "image":
                argv += ["--checkpoint-dir", os.path.join(d, "ck"), "--epoch-csv",
                         os.path.join(d, "e.csv")]
            scraper = _Scraper(port)
            scraper.start()
            for k in KERNEL_WRAPPERS:
                k.launches = 0
            trainer, _, wall = _obs_run(what, fn, argv, before_fit=_flush_each_record)
            counts = [k.launches for k in KERNEL_WRAPPERS]
            reads = scraper.stop()
            launched = [a + b for a, b in zip(launched, counts)]
            want = ([0, 0, 0, 33 * steps, 13 * steps] if what == "image" else
                    [cfg["n_layers"] * steps] * 3 + [0, 0])
            if counts != want or len(trainer.losses) != steps or not all(
                    math.isfinite(float(x)) for x in trainer.losses):
                raise SystemExit(f"phase 24 {what}: launches {counts}, expected {want}; "
                                 f"losses {trainer.losses}")
            _live_checks(what, d, trainer, reads, steps)
            on = (statistics.median(trainer.step_times[1:]) * 1e3,
                  statistics.median(trainer.step_times[-3:]) * 1e3)
            off = medians23[what]
            print(f"[live] {what} with the live flags: steps "
                  f"{[t * 1e3 for t in trainer.step_times]} ms, run {wall} s; median (steps "
                  f"2-{steps}) {on[0]} ms vs phase 23's without flags {off[0]} ms: "
                  f"{100 * (on[0] - off[0]) / off[0]} %; last 3 {on[1]} vs {off[1]} ms: "
                  f"{100 * (on[1] - off[1]) / off[1]} %; launches K1-K5 {counts}; card {card}")
            del trainer
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        k123 = _hang_story(card, cfg)
        print(f"[time] phase 24(c) {time.perf_counter() - t0} s")
        launched = [a + b for a, b in zip(launched, k123 + [0, 0])]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launched


def _serve_args(lm, kv_blocks, extra=()):
    """``serve_lm``'s flags for phase 12's engine cell at the width ``lm``."""
    return serve_lm.build_parser().parse_args([
        "--vocab-size", str(lm["vocab_size"]), "--d-model", str(lm["d_model"]),
        "--n-heads", str(lm["n_heads"]), "--n-layers", str(lm["n_layers"]),
        "--max-batch", "16", "--kv-blocks", str(kv_blocks), "--block-size", "16",
        "--blocks-per-seq", "64", "--chunk-size", "128", "--max-new-tokens", "384",
        "--seed", "0", "--device", "cuda", *extra])


def _zero_launches():
    for k in KERNEL_WRAPPERS:
        k.launches = 0


def serving_obs_phase(dev, card, lm, kv_blocks=385, n_requests=64, n_fleet=32):
    """Phase 25: the serving side's observability and fleet at the width ``lm``.

    (a) phase 12's engine cell through ``serve_lm.serve``, plain (with a
    metrics JSONL, no rules, no watchdog) and then traced
    (``--req-trace --trace-sample 1.0``, a TTFT ceiling over twice the
    plain run's largest TTFT, ``--slo-kv-pct 100``, the watchdog on), with
    two controls: a planted second capture of the decode graph, and a third
    run of the same trace under a ceiling of 0.8 x the traced run's TTFT
    p99.  (b) two ``tools/serve_fleet.py replica --engine --device cuda
    --req-trace`` processes at the same width and seed share the card
    behind the fleet router (``tools/chaoskit.py::replica_kill``): 32
    seeded requests unkilled, then again with replica 1 SIGKILLed after the
    4th completion, while its engine holds requests (all 32 are admitted
    at once on the two engines' 32 slots, so their completions bunch up
    at the end; the drill's plan point, the 15th, can come after replica 1
    has drained).  The launch counters of this process are zeroed just
    before (a) and (b) and read just after each; the replicas report their
    own since they started."""
    from pytorch_distributed_tpu_torch.obs import metrics, reqtrace
    from pytorch_distributed_tpu_torch.tools import chaoskit

    torch.cuda.empty_cache()
    load_cfg = LoadConfig(n_requests=n_requests, rate_rps=200.0, profile="mixed",
                          vocab_size=lm["vocab_size"], prompt_min=128, prompt_max=512,
                          short_min=16, short_max=64, long_min=256, long_max=384,
                          long_frac=0.2, seed=0)
    with tempfile.TemporaryDirectory() as d:
        # (a) plain, then traced with the SLO rules armed above the plain run
        t0 = time.perf_counter()
        _zero_launches()
        plain, peng = serve_lm.serve(_serve_args(lm, kv_blocks, [
            "--no-watchdog", "--metrics-jsonl", os.path.join(d, "plain.jsonl")]),
            generate_load(load_cfg))
        plain_tokens = {r.rid: list(r.generated) for r in peng.finished}
        ceiling = 2e3 * max(peng.ttft_samples) + 100.0
        del peng
        torch.cuda.empty_cache()
        jsonl = os.path.join(d, "traced.jsonl")
        traced, teng = serve_lm.serve(_serve_args(lm, kv_blocks, [
            "--req-trace", "--trace-sample", "1.0", "--slo-ttft-ms", str(ceiling),
            "--slo-kv-pct", "100", "--metrics-jsonl", jsonl]), generate_load(load_cfg))
        records = metrics.read_metrics(jsonl)
        events = [r["ft_event"] for r in records if "ft_event" in r]
        trs = reqtrace.trace_records(records)
        recon = max(abs(sum(float(r[k]) for k in ("queue_wait_ms", "prefill_ms", "redo_wait_ms",
                                                   "defrag_wait_ms", "other_wait_ms"))
                        - float(r["ttft_ms"])) / float(r["ttft_ms"]) for r in trs)
        summ = reqtrace.attribution_summary(trs)
        overhead = 100.0 * (plain["tokens_per_s"] / traced["tokens_per_s"] - 1.0)
        print(f"[obs-serve] plain (metrics JSONL only): {plain['tokens_per_s']} tokens/s, TTFT "
              f"p99 {plain['ttft_p99_ms']} ms; traced (+ tracing, 2 SLO rules, watchdog): "
              f"{traced['tokens_per_s']} tokens/s, TTFT p99 {traced['ttft_p99_ms']} ms; "
              f"difference {overhead}% of tokens/s (one pair); preemptions "
              f"{plain['preemptions']} / {traced['preemptions']}; card {card}")
        print(f"[obs-serve] traced: {traced['traces_completed']} traces, "
              f"{traced['trace_spans_dropped']} spans dropped, "
              f"{traced['trace_violations']} violations of {ceiling} ms; largest "
              f"|sum of TTFT components - TTFT| / TTFT {recon}; tail "
              f"{reqtrace.format_tail_line(summ['tail'])}; watchdog captures "
              f"{teng.watchdog.compiles}; events {sorted(set(events))}")
        traced_tokens = {r.rid: list(r.generated) for r in teng.finished}
        if traced_tokens != plain_tokens:
            bad = [rid for rid in plain_tokens if traced_tokens.get(rid) != plain_tokens[rid]]
            raise SystemExit(f"tracing changed the tokens of requests {bad}")
        if traced["traces_completed"] != n_requests or len(trs) != n_requests:
            raise SystemExit(f"{traced['traces_completed']} traces completed, {len(trs)} "
                             f"reqtrace records, want {n_requests}")
        if not recon <= 0.05:
            raise SystemExit(f"a record's TTFT components miss its TTFT by {recon} (> 5%)")
        if teng.watchdog.compiles != {"serve_decode": 1} or "recompile" in events:
            raise SystemExit(f"the watchdog booked {teng.watchdog.compiles} and events "
                             f"{events.count('recompile')} recompile(s); want one serve_decode "
                             "capture and none")
        if "alert" in events:
            raise SystemExit(f"{events.count('alert')} alert(s) fired under a {ceiling} ms "
                             "ceiling and --slo-kv-pct 100")
        # control 1: a second capture of the same decode step
        wd = teng.watchdog
        ctl = os.path.join(d, "recapture.jsonl")
        wd.obs = metrics.MetricsLogger(ctl, flush_every=1)
        wd.install()
        teng._capture_decode()
        wd.uninstall()
        wd.obs.close()
        booked = [r for r in metrics.read_metrics(ctl) if r.get("ft_event") == "recompile"]
        print(f"[obs-serve] control: a planted recapture booked {len(booked)} recompile "
              f"event(s) {booked[:1]}")
        if len(wd.anomalies) != 1 or len(booked) != 1:
            raise SystemExit("the planted second capture did not book exactly one recompile")
        del teng
        torch.cuda.empty_cache()
        # control 2: the same trace under a ceiling just below the traced p99
        low = 0.8 * traced["ttft_p99_ms"]
        low_jsonl = os.path.join(d, "low.jsonl")
        lows, _ = serve_lm.serve(_serve_args(lm, kv_blocks, [
            "--req-trace", "--slo-ttft-ms", str(low), "--no-watchdog",
            "--metrics-jsonl", low_jsonl]), generate_load(load_cfg))
        fired = [r for r in metrics.read_metrics(low_jsonl)
                 if r.get("ft_event") == "alert" and r.get("rule") == "ttft_p99"]
        print(f"[obs-serve] control: the trace under a {low} ms ceiling (0.8 x the traced p99 "
              f"{traced['ttft_p99_ms']} ms; this run's TTFT p50 {lows['ttft_p50_ms']}, p99 "
              f"{lows['ttft_p99_ms']} ms) booked {len(fired)} ttft_p99 alert(s)")
        if not lows["ttft_p50_ms"] < low < lows["ttft_p99_ms"]:
            raise SystemExit("the control's ceiling does not sit between its run's TTFT p50 "
                             "and p99")
        if not fired:
            raise SystemExit("a ceiling below the TTFT p99 booked no ttft_p99 alert")
        torch.cuda.empty_cache()
        launched = [k.launches for k in KERNEL_WRAPPERS]
        print(f"[obs-serve] kernel launches K1-K5 during phase 25(a): {launched}")
        if any(launched):
            raise SystemExit("the traced engine launched a kernel it should not reach")
        print(f"[time] phase 25(a) took {time.perf_counter() - t0} s")

        # (b) two engine replicas behind the router; replica 1 killed
        t0 = time.perf_counter()
        _zero_launches()
        load = generate_load(LoadConfig(
            n_requests=n_fleet, rate_rps=200.0, profile="mixed", vocab_size=lm["vocab_size"],
            prompt_min=128, prompt_max=512, short_min=16, short_max=64, long_frac=0.0, seed=1))
        prompts = [list(r.prompt) for _, r in load]
        max_new = [r.max_new_tokens for _, r in load]
        flags = ["--engine", "--device", "cuda", "--req-trace", "--vocab-size",
                 str(lm["vocab_size"]), "--d-model", str(lm["d_model"]), "--n-heads",
                 str(lm["n_heads"]), "--n-layers", str(lm["n_layers"]), "--max-batch", "16",
                 "--kv-blocks", str(kv_blocks), "--block-size", "16", "--blocks-per-seq", "64",
                 "--chunk-size", "128", "--max-new-tokens", "64"]
        dense = {}

        def same_tokens(i, base, kill):
            """Phase 12's rule: identical, or the first difference sits where
            the dense top-2 logit gap is under 1e-3."""
            if base == kill:
                return True
            if not dense:
                dense["m"] = TransformerLM(**lm, dtype=torch.float32, device=dev,
                                           attn_impl="dense")
                dense["m"].load_state_dict(init_lm_params(**lm, seed=0, device=dev))
            j = next((j for j, (a, b) in enumerate(zip(base, kill)) if a != b),
                     min(len(base), len(kill)))
            seq = torch.tensor([prompts[i] + base], device=dev)
            with torch.no_grad():
                gap = _top2_gaps(dense["m"](seq)[0, len(prompts[i]) - 1:-1])[j]
            print(f"[obs-serve] request {i} differs after the kill at token {j}; dense top-2 "
                  f"gap there {gap}")
            return len(base) == len(kill) and gap < 1e-3

        ok, rep = chaoskit.replica_kill(os.path.join(d, "fleet"), seed=0, prompts=prompts,
                                        max_new=max_new, flags=flags, boot_timeout_s=300.0,
                                        deadline_s=120.0, probe_timeout_s=5.0,
                                        kill_after=n_fleet // 8,
                                        same_tokens=same_tokens)
        dense.clear()
        launched = [k.launches for k in KERNEL_WRAPPERS]
        print(f"[obs-serve] fleet: {n_fleet} requests over 2 engine replicas on one card, kill "
              f"after completion #{rep['kill_after']}: runs {rep['base_wall_s']} s / "
              f"{rep['kill_wall_s']} s, router TTFT p99 {rep['base_ttft_p99_ms']} / "
              f"{rep['kill_ttft_p99_ms']} ms (ceiling 3 x the first + 250 ms), "
              f"{rep['retries']} retries, attempts sent to replicas 0 and 1 "
              f"{rep['dispatched']}, {rep['replica_down_events']} replica_down, lost "
              f"{rep['lost']}, double-completed {rep['double_completed']}, fleettrace identity "
              f"error {rep['decomp_err_ms_max']} ms, engine TTFT echo error "
              f"{rep['engine_echo_err_ms_max']} ms; kill to the first completion rerouted away "
              f"from replica 1: {rep['kill_to_reroute_ms']} ms; card {card}")
        print(f"[obs-serve] kernel launches K1-K5 during phase 25(b): this process {launched}, "
              f"replicas {rep['replica_launches']}")
        if not ok:
            raise SystemExit("the replica-kill drill failed (FAIL lines above)")
        reps = rep["replica_launches"]
        if any(launched) or sorted(reps) != [0, 1] or any(
                r is None or len(r) != 5 or any(r.values()) for r in reps.values()):
            raise SystemExit("the fleet launched a kernel it should not reach, or a replica "
                             "did not report its launches")
        print(f"[time] phase 25(b) took {time.perf_counter() - t0} s")
    torch.cuda.empty_cache()


# Phase 26: the run's recovery and its report (ROADMAP A11's rollback policy,
# A12's obs_report twin).  The LM spike at step RB_SPIKE_STEP follows the
# snapshot refreshed at step 4 (the save cadence 2), and its step ends on an
# odd count, so no save boundary snapshots the spiked weights; the next steps
# read non-finite and the drain at the next boundary rolls back.  The image
# trainers (JAX's and the port's) read their LR once an epoch, so
# ``LRSpikeAt`` never reaches their step: two poisoned batches in a row force
# the image rollback instead.
RB_SPIKE_STEP, RB_K, RB_CHECK, RB_SAVE = 4, 2, 3, 2
RB_IMAGE_POISON = (1, 3, 4)


def _bytes_of(tensors):
    return [None if t is None else t.detach().reshape(-1).view(torch.uint8).clone()
            for t in tensors]


class _GateCheck:
    """Wraps a trainer's step function: copies the train state (parameters,
    buffers, momentum, ``GradSync`` state) before each step and, when the
    step's ``nonfinite`` flag is set, records whether the state came out
    bitwise as it went in.  Reads the flag every step (a synchronize): the
    checking runs only, never the timed ones.  Attributes (``count``,
    ``comm``) are the wrapped step's."""

    def __init__(self, trainer, attr):
        object.__setattr__(self, "_fn", getattr(trainer, attr))
        object.__setattr__(self, "_trainer", trainer)
        object.__setattr__(self, "flagged", {})
        object.__setattr__(self, "_i", 0)
        setattr(trainer, attr, self)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)

    def __call__(self, batch, lr):
        from pytorch_distributed_tpu_torch.ft.divergence import _state_tensors

        t = self._trainer
        state = lambda: _state_tensors(t.model, t.optimizer, t.comm)  # noqa: E731
        before = _bytes_of(state())
        metrics = self._fn(batch, lr)
        i = self._i
        object.__setattr__(self, "_i", i + 1)
        if float(metrics["nonfinite"]) > 0:
            after = _bytes_of(state())
            self.flagged[i] = all((a is None and b is None) or (a is not None and b is not None
                                                                and torch.equal(a, b))
                                  for a, b in zip(before, after))
        return metrics


def _chaos_hook(*injectors, check=None):
    """A ``before_fit`` hook: the chaos schedule on the built trainer, and
    optionally a ``_GateCheck`` around its step (``check``: the attribute)."""
    from pytorch_distributed_tpu_torch.ft.chaos import ChaosSchedule

    made = {}

    def hook(trainer):
        trainer.chaos = ChaosSchedule(*injectors) if injectors else None
        if check is not None:
            made["check"] = _GateCheck(trainer, check)
    return hook, made


def _finite_state(trainer):
    from pytorch_distributed_tpu_torch.ft.divergence import _state_tensors

    return all(bool(torch.isfinite(t).all()) for t in
               _state_tensors(trainer.model, trainer.optimizer, trainer.comm)
               if t is not None and t.is_floating_point())


def _ft_fold(what, path, guard):
    """The report twin's JSON on one run's JSONL against its guard."""
    from pytorch_distributed_tpu_torch.tools import obs_report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_report.main(["--metrics-jsonl", path, "--format", "json"])
    js = json.loads(buf.getvalue())
    ev, gp = js["ft_events"], js["goodput"]
    got = (ev.get("skip", {}).get("steps"), ev.get("rollback", {}).get("count", 0),
           gp["counts"]["nan_skip"], gp["counts"]["rollback_discard"])
    want = (guard.skipped, guard.rollbacks, len(guard.skipped), guard.rollbacks)
    print(f"[recovery] (c) report of {what}: rc {rc}; ft events {ev}; goodput counts "
          f"{gp['counts']}, badput {gp['badput_s']} s, goodput {gp['goodput_pct']} %")
    if rc != 0 or got != want or not gp["badput_s"]["nan_skip"] > 0:
        raise SystemExit(f"phase 26 (c) {what}: report (skips, rollbacks, nan_skip, "
                         f"rollback_discard) {got}, guard {want}; rc {rc}; badput "
                         f"{gp['badput_s']}")


def recovery_phase(dev, card, cfg, obs_files, steps=16, clean_steps=10, TB=4, TL=4096,
                   img_batch=64, img_steps=8):
    """Phase 26.  Returns the (K1, K2, K3, K4, K5) launches of its runs."""
    from pytorch_distributed_tpu_torch.ft.chaos import LRSpikeAt, NaNBatchAt
    from pytorch_distributed_tpu_torch.tools import obs_report

    root = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    launched = [0] * 5
    lm = ["--vocab", str(cfg["vocab_size"]), "--d-model", str(cfg["d_model"]),
          "--n-heads", str(cfg["n_heads"]), "--n-layers", str(cfg["n_layers"]),
          "--seq-len", str(TL), "-b", str(TB), "--precision", "bf16", "--no-eval",
          "-p", "100", "--device", "cuda"]
    guard = ["--nan-guard", "--ft-rollback-k", str(RB_K), "--ft-check-every", str(RB_CHECK)]

    def run(what, fn, argv, hook, n, want):
        for k in KERNEL_WRAPPERS:
            k.launches = 0
        trainer, out, wall = _obs_run(what, fn, argv, before_fit=hook)
        counts = [k.launches for k in KERNEL_WRAPPERS]
        for j, c in enumerate(counts):
            launched[j] += c
        if counts != want or len(trainer.losses) != n:
            raise SystemExit(f"phase 26 {what}: launches K1-K5 {counts}, expected {want}; "
                             f"{len(trainer.losses)} steps of {n}")
        return trainer, out, wall

    try:
        # (a) the LM cell: the spike with the guard, then without it.
        per = cfg["n_layers"] * steps
        jl = os.path.join(root, "lm_guard.jsonl")
        hook, made = _chaos_hook(LRSpikeAt(RB_SPIKE_STEP, 1e30), check="step_fn")
        t, out, wall = run("(a) LM guard", lm_pretrain.run,
                           lm + guard + ["--steps", str(steps), "--save-steps", str(RB_SAVE),
                                         "--metrics-jsonl", jl], hook, steps, [per] * 3 + [0, 0])
        g, flagged = t.ft_guard, made["check"].flagged
        losses = [float(x) for x in t.losses]
        records = [r for r in obs_report.load_metrics(jl)[0] if "ft_event" in r]
        events = [r["ft_event"] for r in records]
        restored = [r["restored_step"] for r in records if r["ft_event"] == "rollback"]
        print(f"[recovery] (a) LM with the guard: skipped {g.skipped}, rollbacks {g.rollbacks}, "
              f"restored to the snapshots of steps {restored}, lr scale {g.lr_scale}; "
              f"flagged steps bitwise unchanged {flagged}; losses {losses}; events {events}; "
              f"run {wall} s")
        ok = (g.rollbacks >= 1 and g.lr_scale < 1.0 and sorted(flagged) == g.skipped
              and all(flagged.values()) and math.isfinite(losses[-1]) and _finite_state(t)
              and {"skip", "rollback"} <= set(events)
              and "=> divergence rollback at step" in out)
        guard_a = g
        del t, made
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit("phase 26 (a): the guarded LM run failed its checks (above)")
        hook, _ = _chaos_hook(LRSpikeAt(RB_SPIKE_STEP, 1e30))
        t, _, wall = run("(a) LM control", lm_pretrain.run, lm + ["--steps", str(steps)], hook,
                         steps, [per] * 3 + [0, 0])
        finite = _finite_state(t)
        print(f"[recovery] (a) control, the spike without the guard: losses "
              f"{[float(x) for x in t.losses]}; state finite {finite}; run {wall} s")
        del t
        torch.cuda.empty_cache()
        if finite:
            raise SystemExit("phase 26 (a) control: the unguarded spike left finite weights")
        # The guard's cost over the same clean steps.
        clean = {}
        for on in (False, True):
            path = os.path.join(root, f"lm_clean_{int(on)}.jsonl")
            t, _, _ = run(f"(a) LM clean {'with' if on else 'without'} the guard",
                          lm_pretrain.run, lm + (guard if on else []) + [
                              "--steps", str(clean_steps), "--save-steps", str(RB_SAVE),
                              "--metrics-jsonl", path], None, clean_steps,
                          [cfg["n_layers"] * clean_steps] * 3 + [0, 0])
            clean[on] = (statistics.median(t.step_times[1:]) * 1e3, path,
                         [x * 1e3 for x in t.step_times])
            del t
            torch.cuda.empty_cache()
        (off, _, off_all), (on, _, on_all) = clean[False], clean[True]
        print(f"[recovery] (a) LM median step (steps 2-{clean_steps}) with the guard {on} ms vs "
              f"without {off} ms: {100 * (on - off) / off} % (steps {on_all} vs {off_all}; the "
              f"guarded run also copies its state to host memory every {RB_SAVE} steps); "
              f"card {card}")

        # (b) the image cell.
        ji = os.path.join(root, "image_guard.jsonl")
        image = ["-a", "resnet50", "--synthetic", "--fused-convbn", "-b", str(img_batch),
                 "--image-size", "224", "--synthetic-length", str(img_batch * img_steps),
                 "--epochs", "1", "--precision", "bf16", "--seed", "0", "-p", "100",
                 "--device", "cuda", "--checkpoint-dir", os.path.join(root, "ck"),
                 "--epoch-csv", os.path.join(root, "e.csv"), "--save-steps", str(RB_SAVE),
                 "--metrics-jsonl", ji] + guard
        hook, made = _chaos_hook(NaNBatchAt(RB_IMAGE_POISON, keys=("images",)),
                                 check="train_step")
        t, out, wall = run("(b) image guard", tpu_native.run, image, hook, img_steps,
                           [0, 0, 0, 33 * img_steps, 13 * img_steps])
        g, flagged = t.ft_guard, made["check"].flagged
        losses = [float(x) for x in t.losses]
        print(f"[recovery] (b) ResNet-50 b{img_batch} with the guard: skipped {g.skipped}, "
              f"rollbacks {g.rollbacks}, lr scale {g.lr_scale}; poisoned steps bitwise "
              f"unchanged (weights, momentum, BN statistics) {flagged}; losses {losses}; "
              f"run {wall} s")
        ok = (g.skipped == list(RB_IMAGE_POISON) and g.rollbacks == 1
              and sorted(flagged) == g.skipped and all(flagged.values())
              and math.isfinite(losses[-1]) and _finite_state(t))
        guard_b = g
        del t, made
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit("phase 26 (b): the guarded image run failed its checks (above)")

        # (c) the report twin folds (a), (b) and phase 23's files.
        _ft_fold("(a)", jl, guard_a)
        _ft_fold("(b)", ji, guard_b)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_report.main(["--metrics-jsonl", os.path.join(obs_files, "lm_m.jsonl"),
                                  "--hb-dir", os.path.join(obs_files, "lm_hb"),
                                  "--telemetry-csv", os.path.join(obs_files, "image_t.csv")])
            rc_img = obs_report.main(["--metrics-jsonl",
                                      os.path.join(obs_files, "image_m.jsonl"),
                                      "--hb-dir", os.path.join(obs_files, "image_hb")])
        text = buf.getvalue()
        print(f"[recovery] (c) report of phase 23's LM and image runs: rc {rc}, {rc_img}")
        for line in text.splitlines():
            print(f"[recovery] (c) | {line}")
        if rc != 0 or rc_img != 0 or "== goodput ==" not in text:
            raise SystemExit(f"phase 26 (c): phase 23's report exited {rc}, {rc_img}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_report.main(["--diff", clean[False][1], clean[True][1]])
        for line in buf.getvalue().splitlines():
            print(f"[recovery] (c) diff | {line}")
        print(f"[recovery] (c) --diff of the clean LM runs, without vs with the guard: exit "
              f"{rc} (no limit); card {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launched


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

    # 2. kernel vs plain version.  Tolerances.  f32 runs on the CUDA cores:
    # both sides compute in f32 from the same inputs and differ only in
    # summation order, so outputs agree to ~1e-6 relative (atol and rtol
    # 1e-5 allowed).  bf16 runs on the tensor cores, whose p . v takes p
    # rounded to bf16 (as FlashAttention-2/3 and SDPA do) where the plain
    # version keeps it f32; both round O to bf16.  Emulated on the CPU
    # (tests/test_torch_flash_attention.py), that costs ~2.0e-3-2.4e-3
    # relative Frobenius error and up to ~0.47 of atol 4e-3 of max|O| +
    # rtol 1e-2 per element; so bf16 holds those, and a relative Frobenius
    # error <= 5e-3, as K2/K3 do.  lse is f32 from f32 s on both sides and
    # differs in summation order only: 1e-4 (it is of size log L).  Each
    # case slices q, k, v out of one [B, L, 3, H, D] tensor, with the
    # strides of the fused qkv projection's views that reach the kernel
    # when serving.
    cases = [
        dict(name="path", B=4, L=4096, H=16, D=64, causal=True,
             dtype=torch.bfloat16, atol=4e-3, rtol=1e-2, frob=5e-3),
        dict(name="ragged_bf16", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.bfloat16, atol=4e-3, rtol=1e-2, frob=5e-3),
        dict(name="ragged", B=2, L=1000, H=4, D=128, causal=False,
             dtype=torch.float32, atol=1e-5, rtol=1e-5, frob=None),
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
        err_lse = (lse - ref_lse).abs().max().item()
        ok_lse = torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)
        frob = _frob(out, ref_out)
        if c["frob"] is None:
            err_out = (out.float() - ref_out.float()).abs().max().item()
            ok_out = torch.allclose(out.float(), ref_out.float(), atol=c["atol"], rtol=c["rtol"])
        else:
            err_out, ok_out = _agree(out, ref_out, c["atol"], c["rtol"])
            ok_out = ok_out and frob <= c["frob"]
        same = None
        if c["name"] == "path":
            out2, lse2 = flash_attention(q, k, v, c["causal"])
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            del out2, lse2
        del ref_out, ref_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = _ms(lambda: flash_attention(q, k, v, c["causal"]), 20)
        plain_ms = _ms(lambda: flash_attention_reference(q, k, v, c["causal"]), 3, 1)
        lib_ms = _ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=c["causal"]), 20)
        bound, bound_by = _bound_ms(B, L, H, D, c["causal"], c["dtype"] == torch.bfloat16)
        flops = 4 * D * (L * (L + 1) // 2 if c["causal"] else L * L) * B * H
        results[c["name"]] = dict(err=err_out, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
        atol_of = "" if c["frob"] is None else " of max|ref|"
        print(f"[kernel] {c['name']} B={B} L={L} H={H} D={D} causal={c['causal']} "
              f"{c['dtype']}: out max err {err_out:.3e} (atol {c['atol']}{atol_of}, rtol "
              f"{c['rtol']}), relative Frobenius {frob:.3e} (limit {c['frob']}); lse max err "
              f"{err_lse:.3e} (atol 1e-4); kernel {ms} ms, {flops / ms / 1e9} TFLOP/s, "
              f"{100 * bound / ms}% of its bound {bound} ms ({bound_by}); plain {plain_ms} ms, "
              f"sdpa {lib_ms} ms" + ("" if same is None else f"; two runs bit-identical: {same}"))
        if not (ok_out and ok_lse):
            raise SystemExit(f"flash kernel disagrees with its plain version at {c['name']}")
        if same is False:
            raise SystemExit("flash kernel gave different bits on a rerun")
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
    # only (bf16 products run on the tensor cores, bf16 x bf16 exact in f32
    # and summed in f32, so only the order changes there too), so a
    # bf16 da may round one ulp (2^-8 relative) apart: rtol 1e-2,
    # atol 1e-3 of max|ref| for entries near zero; dW is f32 on both sides,
    # sums of up to 802,816 terms in another order: atol 1e-4 of max|ref|,
    # rtol 1e-3.  f32 ragged shapes: atol 1e-5 of max|ref|, rtol 1e-4.
    bf16 = torch.bfloat16
    conv_cases = [
        dict(name="k4_path", ks=1, N=256, H=56, W=56, Ci=256, Co=64, dtype=bf16, relu=True),
        dict(name="k4_64_256", ks=1, N=256, H=56, W=56, Ci=64, Co=256, dtype=bf16,
             relu=False),
        dict(name="k4_256_128", ks=1, N=256, H=56, W=56, Ci=256, Co=128, dtype=bf16,
             relu=True),
        dict(name="k4_512_128", ks=1, N=256, H=28, W=28, Ci=512, Co=128, dtype=bf16,
             relu=False),
        dict(name="k4_1024_256", ks=1, N=256, H=14, W=14, Ci=1024, Co=256, dtype=bf16,
             relu=True),
        dict(name="k4_2048_512", ks=1, N=256, H=7, W=7, Ci=2048, Co=512, dtype=bf16,
             relu=False),
        dict(name="k4_512_2048", ks=1, N=256, H=7, W=7, Ci=512, Co=2048, dtype=bf16,
             relu=True),
        dict(name="k4_64_64", ks=1, N=256, H=56, W=56, Ci=64, Co=64, dtype=bf16, relu=True),
        dict(name="k4_128_512", ks=1, N=256, H=28, W=28, Ci=128, Co=512, dtype=bf16,
             relu=True),
        dict(name="k4_512_256", ks=1, N=256, H=28, W=28, Ci=512, Co=256, dtype=bf16,
             relu=True),
        dict(name="k4_256_1024", ks=1, N=256, H=14, W=14, Ci=256, Co=1024, dtype=bf16,
             relu=False),
        dict(name="k4_1024_512", ks=1, N=256, H=14, W=14, Ci=1024, Co=512, dtype=bf16,
             relu=True),
        dict(name="k4_ragged_bf16", ks=1, N=3, H=9, W=11, Ci=70, Co=33, dtype=bf16,
             relu=True),
        dict(name="k5_path", ks=3, N=256, H=56, W=56, Ci=64, Co=64, dtype=bf16, relu=True),
        dict(name="k5_28x28_128", ks=3, N=256, H=28, W=28, Ci=128, Co=128, dtype=bf16,
             relu=True),
        dict(name="k5_14x14_256", ks=3, N=256, H=14, W=14, Ci=256, Co=256, dtype=bf16,
             relu=True),
        dict(name="k5_7x7_512", ks=3, N=256, H=7, W=7, Ci=512, Co=512, dtype=bf16,
             relu=True),
        dict(name="k5_ragged_bf16", ks=3, N=3, H=9, W=11, Ci=70, Co=33, dtype=bf16,
             relu=True),
        # Non-square planes the slot rule folds: a 448 x 256 batch's stage
        # 1, and the widest planes at h = 1 for 64 and 256 channels, which
        # take the kernels' banded halo.
        dict(name="k5_64x112", ks=3, N=8, H=64, W=112, Ci=64, Co=64, dtype=bf16, relu=True),
        dict(name="k5_1x2656", ks=3, N=4, H=1, W=2656, Ci=64, Co=64, dtype=bf16, relu=True),
        dict(name="k5_1x1219", ks=3, N=2, H=1, W=1219, Ci=256, Co=256, dtype=bf16,
             relu=False),
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
        same = None
        if dt == bf16:
            da2, dw2 = kernel(*args)
            same = torch.equal(da, da2) and torch.equal(dw, dw2)
            del da2, dw2
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
        flops = _conv_bn_bwd_flops(ks, N, H, W, Ci, Co)
        conv[c["name"]] = dict(err=max(e_da, e_dw), ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
        print(f"[conv-bn kernel] {c['name']} K{4 if ks == 1 else 5} N={N} H={H} W={W} "
              f"Ci={Ci} Co={Co} {dt} relu={relu}: max err da {e_da:.3e} dW {e_dw:.3e}; "
              f"kernel {ms} ms, {flops / ms / 1e9} TFLOP/s, {100 * bound / ms}% of its bound "
              f"{bound} ms ({bound_by}); plain {plain_ms} ms, dy + cuDNN backward {lib_ms} ms"
              + ("" if same is None else f"; two runs bit-identical: {same}"))
        if not (ok_da and ok_dw):
            raise SystemExit(f"fused conv-BN kernel disagrees with its plain version at "
                             f"{c['name']}")
        if same is False:
            raise SystemExit("fused conv-BN kernel gave different bits on a rerun")
        del y, do, a, w, wc, a_nchw, args
    torch.cuda.empty_cache()
    k4_per_step = {"k4_64_64": 1, "k4_64_256": 4, "k4_path": 2, "k4_256_128": 1,
                   "k4_128_512": 4, "k4_512_128": 3, "k4_512_256": 1, "k4_256_1024": 6,
                   "k4_1024_256": 5, "k4_1024_512": 1, "k4_512_2048": 3, "k4_2048_512": 2}
    k4_step = {key: sum(n * conv[name][key] for name, n in k4_per_step.items())
               for key in ("ms", "bound_ms", "library_ms")}
    print(f"[conv-bn kernel] K4 over one ResNet-50 b256 bf16 step "
          f"({sum(k4_per_step.values())} launches, phase 8's times): kernel {k4_step['ms']} ms, "
          f"bound {k4_step['bound_ms']} ms ({100 * k4_step['bound_ms'] / k4_step['ms']}%), "
          f"dy + cuDNN backward {k4_step['library_ms']} ms")

    # 9. the image training path at full ResNet-50 width, through the recipe
    steps, per_step = 8, (33, 13)
    fused_dgrad_wgrad.launches = fused_dgrad_wgrad_3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_image_")  # the epoch-end save
    try:
        image = tpu_native.run([
            "-a", "resnet50", "--synthetic", "--fused-convbn", "-b", "256", "--image-size",
            "224", "--synthetic-length", str(256 * steps), "--epochs", "1", "--precision",
            "bf16", "--seed", "0", "-p", "1", "--epoch-csv", "build/tpu_native_smoke.csv",
            "--checkpoint-dir", ckpt_dir, "--device", "cuda"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
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

    # 11. fused vs unfused bf16 image step time, both in this call.
    tb, warm, timed = 256, 2, 7
    host = list(DataLoader(SyntheticImageDataset(tb * (warm + timed), image_size=224), tb,
                           num_workers=4, drop_last=True))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    del host
    step_ms, weights = {}, None
    for fused in (True, False):
        model = models.create_model("resnet50", dtype=torch.bfloat16, fused_convbn=fused,
                                    device=dev)
        if weights is None:
            model.init_weights(torch.Generator(device=dev).manual_seed(0))
            weights = {k: t.clone() for k, t in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        step = make_train_step(model, sgd(model.parameters(), 0.1))
        times = []
        for batch in batches:
            t0 = time.perf_counter()
            step(batch, 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[fused] = statistics.median(times[warm:])
        print(f"[image step] ResNet-50 {'fused' if fused else 'unfused'} B={tb} 224x224 bf16 "
              f"compute, f32 weights: median {step_ms[fused]} ms of steps {warm + 1}-"
              f"{warm + timed} (all {times}), {tb / step_ms[fused] * 1e3} images/s")
        del model, step
    del weights, batches
    torch.cuda.empty_cache()
    print(f"[image step] fused / unfused = {step_ms[True] / step_ms[False]} "
          f"({step_ms[True]} / {step_ms[False]} ms); card {card}")

    # 12. the paged serving engine at full width
    serving_engine_phase(dev, card, cfg)

    # 13. checkpoints at full width: resume, sample and serve from the files
    t0 = time.perf_counter()
    k1, k2, k3, k1_gen, k4, k5 = checkpoint_phase(dev, card, cfg, recipe_prompt)
    print(f"[time] phase 13 took {time.perf_counter() - t0} s")

    # 14. the bench.py twin
    t0 = time.perf_counter()
    bench_phase(card)
    print(f"[time] phase 14 took {time.perf_counter() - t0} s")

    # 15. tpu_native --data on an ImageFolder tree, once per --wire
    t0 = time.perf_counter()
    k4_data, k5_data = data_phase(dev, card)
    print(f"[time] phase 15 took {time.perf_counter() - t0} s")

    # 16. the data-parallel recipes through their launchers
    t0 = time.perf_counter()
    k4_dp, k5_dp = dp_phase(card)
    print(f"[time] phase 16 took {time.perf_counter() - t0} s")

    # 17. lm_pretrain --fused-ce at full width
    t0 = time.perf_counter()
    (k1_ce, k2_ce, k3_ce), lm_unfused_ms = fused_ce_phase(dev, card, cfg)
    print(f"[time] phase 17 took {time.perf_counter() - t0} s")

    # 18. int8 weight-only generate and speculative decoding
    t0 = time.perf_counter()
    k1_int8 = generate_variants_phase(dev, card, cfg)
    print(f"[time] phase 18 took {time.perf_counter() - t0} s")

    # 19. the serving engine at int8 and with a speculative draft
    t0 = time.perf_counter()
    engine_variants_phase(dev, card, cfg)
    print(f"[time] phase 19 took {time.perf_counter() - t0} s")

    # 20. the gradient-communication stack: quantized wires, ZeRO, overlap
    t0 = time.perf_counter()
    k1_a9, k2_a9, k3_a9, k4_a9, k5_a9 = a9_phase(dev, card, cfg, lm_unfused_ms)
    print(f"[time] phase 20 took {time.perf_counter() - t0} s")

    # 21. the rest of the image zoo
    t0 = time.perf_counter()
    zoo_phase(dev, card)
    print(f"[time] phase 21 took {time.perf_counter() - t0} s")

    # 22. LM training across ranks and lm_generate --tp
    t0 = time.perf_counter()
    k1_mesh, k2_mesh, k3_mesh = lm_mesh_phase(dev, card, cfg, lm_unfused_ms)
    print(f"[time] phase 22 took {time.perf_counter() - t0} s")

    # 23. the training metrics stream through both trainers
    t0 = time.perf_counter()
    obs_files = tempfile.mkdtemp(prefix="chip_smoke_obs_files_")
    (k1_obs, k2_obs, k3_obs, k4_obs, k5_obs), medians23 = obs_phase(dev, card, cfg,
                                                                    keep=obs_files)
    print(f"[time] phase 23 took {time.perf_counter() - t0} s")

    # 24. the death paths and the live plane through both trainers
    t0 = time.perf_counter()
    k1_live, k2_live, k3_live, k4_live, k5_live = live_phase(dev, card, cfg, medians23)
    print(f"[time] phase 24 took {time.perf_counter() - t0} s")

    # 25. the serving side's observability and fleet
    t0 = time.perf_counter()
    serving_obs_phase(dev, card, cfg)
    print(f"[time] phase 25 took {time.perf_counter() - t0} s")

    # 26. the divergence guard's rollback through both trainers, and its report
    t0 = time.perf_counter()
    try:
        k1_ft, k2_ft, k3_ft, k4_ft, k5_ft = recovery_phase(dev, card, cfg, obs_files)
    finally:
        shutil.rmtree(obs_files, ignore_errors=True)
    print(f"[time] phase 26 took {time.perf_counter() - t0} s")

    path = results["path"]
    kernels = [dict(
        name="flash_attention_fwd", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="pytorch_distributed_tpu/ops/flash_attention.py:37",
        launches=(serve_launches + train_launches[0] + k1 + k1_gen + k1_ce + k1_int8 + k1_a9
                  + k1_mesh + k1_obs + k1_live + k1_ft),
        max_abs_err=path["err"],
        ms=path["ms"], plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
        bound_by=path["bound_by"], library_ms=path["library_ms"])]
    bpath = bwd["path"]
    for name, key, line, n in (("flash_attention_bwd_dq", "dq", 185,
                                train_launches[1] + k2 + k2_ce + k2_a9 + k2_mesh + k2_obs
                                + k2_live + k2_ft),
                               ("flash_attention_bwd_dkv", "dkv", 214,
                                train_launches[2] + k3 + k3_ce + k3_a9 + k3_mesh + k3_obs
                                + k3_live + k3_ft)):
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"pytorch_distributed_tpu/ops/flash_attention.py:{line}",
            launches=n, max_abs_err=bpath[key]["err"], ms=bpath[key]["ms"],
            plain_ms=bpath["plain_ms"], bound_ms=bpath[key]["bound_ms"],
            bound_by=bpath[key]["bound_by"], library_ms=bpath["library_ms"]))
    for name, key, line, n in (("fused_dgrad_wgrad", "k4_path", 122,
                                image_launches[0] + k4 + k4_data + k4_dp + k4_a9 + k4_obs
                                + k4_live + k4_ft),
                               ("fused_dgrad_wgrad_3x3", "k5_path", 210,
                                image_launches[1] + k5 + k5_data + k5_dp + k5_a9 + k5_obs
                                + k5_live + k5_ft)):
        kp = conv[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_tpu_torch/csrc/fused_conv_bn_bwd.cu",
            replaces=f"pytorch_distributed_tpu/ops/fused_conv_bn.py:{line}",
            launches=n, max_abs_err=kp["err"], ms=kp["ms"], plain_ms=kp["plain_ms"],
            bound_ms=kp["bound_ms"], bound_by=kp["bound_by"], library_ms=kp["library_ms"]))
    print(f"[time] phases 1-26 took {time.perf_counter() - t_start} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--recipe-worker"]:
        sys.exit(recipe_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--a9-worker"]:
        sys.exit(a9_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--lm-worker"]:
        sys.exit(lm_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--lm-mesh-worker"]:
        sys.exit(lm_mesh_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--ft-worker"]:
        sys.exit(ft_worker(sys.argv[2:]))
    sys.exit(main())
