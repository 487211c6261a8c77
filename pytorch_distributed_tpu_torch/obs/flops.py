"""Efficiency accounting: analytic per-step FLOPs/bytes models and MFU/HFU,
the port of ``pytorch_distributed_tpu/obs/flops.py``.

For each model family with an analytic model it builds a ``StepCost`` —
matmul/conv core FLOPs for forward + backward + optimizer update, plus a
rough HBM bytes estimate — and divides achieved FLOP/s by the card's peak:

- **MFU** uses *model* FLOPs: the algorithmically necessary work (the
  PaLM-appendix convention).  Recompute taxes do not inflate it.
- **HFU** uses *hardware* FLOPs: model FLOPs plus rematerialization /
  fused-CE chunk-recompute work.  HFU >= MFU; the gap is the recompute tax.

Counting conventions (the JAX package's, chosen there to match XLA's
``cost_analysis()``; ``StepCost`` and the walks are copies, so both
packages give the same numbers):

- one multiply-add = 2 FLOPs;
- convolutions exclude padded taps (border pixels cost less);
- backward = 2x forward for the matmul/conv core (dgrad + wgrad);
- the SGD update is ~6 FLOPs/param and is replicated on every rank under
  data parallelism (``StepCost.per_device_flops``);
- elementwise/transcendental work (BN, layernorm, softmax, rope) is not
  counted.

The cross-check, ``counted_step_flops``, is the twin of the JAX
``xla_step_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over one
call of a train step, with the convolution formulas replaced by the
valid-tap convention above.  It counts the CPU path only: K1-K5 are
``ctypes`` launches (``ops/_build.py``) that the counter cannot see, while
on CPU tensors their wrappers run their plain PyTorch versions, whose
products it does see.

The card tables are keyed by the lower-cased CUDA device name
(``torch.cuda.get_device_name``); ``PTD_TPU_*`` environment variables
override them, as in the JAX package, and ``device="cpu"`` (or no card)
gets the JAX package's CPU placeholders, which are plumbing values, never
measurements.  A CUDA card the tables do not know raises rather than
inventing a denominator.  The communication-byte models
(``image_comm_bytes*``, ``lm_comm_bytes``, ``zero_wire_parity``,
``comm_cost_wire_bytes``) wait for the comm ledger (ROADMAP.md item A13).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

# --------------------------------------------------------------------- peaks
# Dense-matmul peak per card, FLOP/s, at the framework's bf16 compute
# policy.  One peak per card, as the JAX package keeps one per chip: the
# H100's f32 (non-tensor-core) peak is 67e12, and an f32 run's MFU against
# the bf16 figure reads low by that ratio.
PEAK_FLOPS_PER_CHIP: Dict[str, float] = {
    "nvidia h100": 989e12,
}

# CPU placeholder (the JAX package's): keeps MFU finite and deterministic
# in CPU runs; never a measurement.
CPU_FALLBACK_PEAK = 50e9

# Device memory per card, bytes (``device_hbm_bytes`` asks the card first).
HBM_BYTES_PER_CHIP: Dict[str, float] = {
    "nvidia h100": 80e9,
}
CPU_FALLBACK_HBM = 4e9

# Nominal aggregate NVLink bandwidth per card, bytes/s: a scoring
# denominator for predicted comm time, not a measurement.
LINK_BYTES_PER_CHIP: Dict[str, float] = {
    "nvidia h100": 900e9,
}
CPU_FALLBACK_LINK = 10e9

# Memory bandwidth per card, bytes/s: the memory-roofline denominator
# (``obs/stepattr.py``).
HBM_BW_PER_CHIP: Dict[str, float] = {
    "nvidia h100": 3.35e12,
}
CPU_FALLBACK_HBM_BW = 20e9


def device_kind(device=None) -> str:
    """The lower-cased CUDA device name of ``device`` (a ``torch.device``,
    a string or an index; None: the current card, if there is one), or
    ``""`` for the CPU.  Imports torch, unlike the table lookups."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.cuda.current_device()
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return ""
        device = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_name(device).lower()


def _chip_table_lookup(table: Dict[str, float], kind: Optional[str],
                       fallback: float, env: str) -> float:
    """Shared name-prefix lookup for the capability tables: the env
    override, else the table's entry for ``kind``, else (``kind`` empty or
    None: the CPU) the placeholder.  A card the table does not know
    raises."""
    env_val = os.environ.get(env)
    if env_val:
        return float(env_val)
    kind = (kind or "").lower()
    for prefix, value in table.items():
        if kind.startswith(prefix):
            return value
    if kind:
        raise ValueError(f"no {env[len('PTD_TPU_'):].lower()} entry for the card {kind!r} "
                         f"(obs/flops.py knows {sorted(table)}); set {env}")
    return fallback


def device_peak_flops(device=None) -> float:
    """Peak FLOP/s for one card (``PTD_TPU_PEAK_FLOPS`` overrides); the
    CPU placeholder for ``device="cpu"`` or without a card."""
    env = os.environ.get("PTD_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    return chip_peak_flops(device_kind(device))


def device_hbm_bytes(device=None) -> float:
    """Device memory of one card, bytes: ``PTD_TPU_HBM_BYTES``, else the
    card's own ``total_memory``, else the table's entry (the CPU: the
    placeholder)."""
    env = os.environ.get("PTD_TPU_HBM_BYTES")
    if env:
        return float(env)
    kind = device_kind(device)
    if kind:
        import torch

        dev = torch.device(device) if isinstance(device, str) else device
        index = dev.index if isinstance(dev, torch.device) else dev
        return float(torch.cuda.get_device_properties(
            index if index is not None else torch.cuda.current_device()).total_memory)
    return chip_hbm_bytes(kind)


def chip_hbm_bytes(kind: Optional[str] = None) -> float:
    """Device memory bytes for a device-name string (``PTD_TPU_HBM_BYTES``
    overrides)."""
    return _chip_table_lookup(HBM_BYTES_PER_CHIP, kind, CPU_FALLBACK_HBM,
                              "PTD_TPU_HBM_BYTES")


def chip_link_bytes(kind: Optional[str] = None) -> float:
    """Nominal aggregate NVLink bytes/s per card (``PTD_TPU_LINK_BYTES``
    overrides)."""
    return _chip_table_lookup(LINK_BYTES_PER_CHIP, kind, CPU_FALLBACK_LINK,
                              "PTD_TPU_LINK_BYTES")


def chip_hbm_bw(kind: Optional[str] = None) -> float:
    """Memory bandwidth per card, bytes/s (``PTD_TPU_HBM_BW`` overrides)."""
    return _chip_table_lookup(HBM_BW_PER_CHIP, kind, CPU_FALLBACK_HBM_BW,
                              "PTD_TPU_HBM_BW")


def chip_peak_flops(kind: Optional[str] = None) -> float:
    """Peak FLOP/s per card from a device-name string
    (``PTD_TPU_PEAK_FLOPS`` overrides)."""
    return _chip_table_lookup(PEAK_FLOPS_PER_CHIP, kind, CPU_FALLBACK_PEAK,
                              "PTD_TPU_PEAK_FLOPS")


# ---------------------------------------------------------------- step costs
@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-optimizer-step cost of one registered model family config.

    ``model_flops``    algorithmic FLOPs (MFU numerator);
    ``hardware_flops`` incl. remat / fused-CE recompute (HFU numerator);
    ``bytes``          rough HBM traffic (params+grads+optimizer r/w and
                       activations twice) — an arithmetic-intensity hint,
                       not cross-checked;
    ``update_flops``   optimizer portion (replicated per device under DP);
    ``params``         parameter count the update estimate used.
    """

    model_flops: float
    hardware_flops: float
    bytes: float
    update_flops: float
    params: int
    breakdown: Dict[str, float]

    def per_device_flops(self, n_devices: int) -> float:
        """Per-device estimate: the forward/backward core is sharded over
        the ranks but the optimizer update runs replicated on every one."""
        n = max(1, int(n_devices))
        return (self.hardware_flops - self.update_flops) / n + self.update_flops


_SGD_FLOPS_PER_PARAM = 6.0  # wd mul-add, momentum mul-add, lr mul + sub


def _valid_taps(size: int, k: int, stride: int, pad: int) -> int:
    """Sum over output positions of in-bounds kernel taps along one spatial
    dim — the XLA convolution convention (padded taps cost nothing)."""
    out = (size + 2 * pad - k) // stride + 1
    total = 0
    for o in range(out):
        start = o * stride - pad
        total += max(0, min(start + k, size) - max(start, 0))
    return total


class _Walk:
    """Accumulator the per-family shape walks share."""

    def __init__(self):
        self.fwd = 0.0        # forward core FLOPs per sample
        self.params = 0
        self.act_elts = 0.0   # activation elements produced per sample

    def conv(self, h, w, cin, cout, kh, kw, stride=1, pad=None, groups=1,
             bn=True):
        if pad is None:
            pad = kh // 2
        th = _valid_taps(h, kh, stride, pad)
        tw = _valid_taps(w, kw, stride, pad)
        ho = (h + 2 * pad - kh) // stride + 1
        wo = (w + 2 * pad - kw) // stride + 1
        self.fwd += 2.0 * cout * (cin / groups) * th * tw
        self.params += kh * kw * (cin // groups) * cout + (2 * cout if bn else 0)
        self.act_elts += ho * wo * cout
        return ho, wo

    def dense(self, n_rows, cin, cout, params=True):
        self.fwd += 2.0 * n_rows * cin * cout
        if params:
            self.params += cin * cout + cout
        self.act_elts += n_rows * cout


# ResNet-family table mirroring the JAX package's models/resnet.py zoo:
# (stage_sizes, block, groups, base_width).
_RESNET_CFGS: Dict[str, tuple] = {
    "resnet18": ([2, 2, 2, 2], "basic", 1, 64),
    "resnet34": ([3, 4, 6, 3], "basic", 1, 64),
    "resnet50": ([3, 4, 6, 3], "bottleneck", 1, 64),
    "resnet101": ([3, 4, 23, 3], "bottleneck", 1, 64),
    "resnet152": ([3, 8, 36, 3], "bottleneck", 1, 64),
    "wide_resnet50_2": ([3, 4, 6, 3], "bottleneck", 1, 128),
    "wide_resnet101_2": ([3, 4, 23, 3], "bottleneck", 1, 128),
    "resnext50_32x4d": ([3, 4, 6, 3], "bottleneck", 32, 4),
    "resnext101_32x8d": ([3, 4, 23, 3], "bottleneck", 32, 8),
}

# ViT table mirroring the JAX package's models/vit.py: (patch, d_model, layers, heads, mlp).
_VIT_CFGS: Dict[str, tuple] = {
    "vit_b_16": (16, 768, 12, 12, 3072),
    "vit_b_32": (32, 768, 12, 12, 3072),
    "vit_l_16": (16, 1024, 24, 16, 4096),
}


def _resnet_walk(arch: str, image_size: int, num_classes: int) -> _Walk:
    stage_sizes, block, groups, base_width = _RESNET_CFGS[arch]
    exp = 1 if block == "basic" else 4
    wk = _Walk()
    h, w = wk.conv(image_size, image_size, 3, 64, 7, 7, stride=2, pad=3)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # maxpool 3x3 s2 p1
    c = 64
    for i, nblk in enumerate(stage_sizes):
        filt = 64 * 2 ** i
        for j in range(nblk):
            s = 2 if (i > 0 and j == 0) else 1
            if block == "basic":
                h2, w2 = wk.conv(h, w, c, filt, 3, 3, stride=s)
                wk.conv(h2, w2, filt, filt, 3, 3)
            else:
                width = int(filt * base_width / 64) * groups
                wk.conv(h, w, c, width, 1, 1, pad=0)
                h2, w2 = wk.conv(h, w, width, width, 3, 3, stride=s,
                                 groups=groups)
                wk.conv(h2, w2, width, filt * exp, 1, 1, pad=0)
            if c != filt * exp or s > 1:
                wk.conv(h, w, c, filt * exp, 1, 1, stride=s, pad=0)
            h, w, c = h2, w2, filt * exp
    wk.dense(1, c, num_classes)
    return wk


def _transformer_core(wk: _Walk, tokens: float, d: int, mlp: int,
                      seq: float) -> None:
    """One transformer block's matmul core for ``tokens`` rows attending
    over a ``seq``-long context (dense attention: causal masking does not
    reduce the products the JAX package's convention counts)."""
    wk.dense(tokens, d, 3 * d, params=False)      # qkv
    wk.params += 3 * d * d                        # transformer.py: no bias
    wk.fwd += 4.0 * tokens * seq * d              # scores + weighted sum
    wk.act_elts += tokens * seq                   # score matrix (per head sum)
    wk.dense(tokens, d, d, params=False)          # proj
    wk.params += d * d
    wk.dense(tokens, d, mlp)                      # fc1
    wk.dense(tokens, mlp, d)                      # fc2
    wk.params += 4 * d                            # two layernorms


def _vit_walk(arch: str, image_size: int, num_classes: int) -> _Walk:
    patch, d, layers, _heads, mlp = _VIT_CFGS[arch]
    grid = image_size // patch
    tokens = grid * grid + 1  # + class token
    wk = _Walk()
    wk.dense(grid * grid, patch * patch * 3, d)   # patch embed
    wk.params += d + tokens * d                   # cls token + pos embeddings
    for _ in range(layers):
        _transformer_core(wk, tokens, d, mlp, tokens)
    wk.dense(1, d, num_classes)                   # head (class token only)
    return wk


def _finish(wk: _Walk, batch: int, recompute_fwd: float = 0.0,
            breakdown: Optional[Dict[str, float]] = None) -> StepCost:
    fwd = wk.fwd * batch
    update = _SGD_FLOPS_PER_PARAM * wk.params
    model = 3.0 * fwd + update
    hardware = model + recompute_fwd * batch
    # Rough bytes: params+grads+momentum r/w (f32) + activations twice
    # (produce in fwd, re-read in bwd) at 4 bytes — an intensity hint only.
    nbytes = 6.0 * 4 * wk.params + 2.0 * 4 * wk.act_elts * batch
    bd = {"forward": fwd, "backward": 2.0 * fwd, "update": update,
          "recompute": recompute_fwd * batch}
    if breakdown:
        bd.update(breakdown)
    return StepCost(model_flops=model, hardware_flops=hardware, bytes=nbytes,
                    update_flops=update, params=wk.params, breakdown=bd)


def image_step_cost(arch: str, batch: int, image_size: int,
                    num_classes: int = 1000, remat: bool = False) -> StepCost:
    """Analytic train-step cost for the image families with an analytic
    model (ResNet zoo + ViT).  Other archs raise — silently guessing a
    denominator would make MFU numbers lies."""
    if arch in _RESNET_CFGS:
        wk = _resnet_walk(arch, image_size, num_classes)
        recompute = 0.0
    elif arch in _VIT_CFGS:
        wk = _vit_walk(arch, image_size, num_classes)
        # remat on every encoder block replays the block forwards in
        # backward: ~+1x forward of the block stack.
        recompute = wk.fwd if remat else 0.0
    else:
        raise ValueError(
            f"no analytic FLOPs model for arch {arch!r}; --mfu supports "
            f"{sorted(_RESNET_CFGS) + sorted(_VIT_CFGS)} (obs/flops.py)")
    return _finish(wk, batch, recompute_fwd=recompute)


def lm_step_cost(vocab_size: int, d_model: int, n_layers: int, batch: int,
                 seq_len: int, mlp_ratio: int = 4, fused_ce: bool = False) -> StepCost:
    """Analytic train-step cost for the transformer-LM family (the JAX
    model's, without the pipeline's remat and the MoE layers, which the
    port does not have yet).

    ``fused_ce``: the chunked tied-head+CE backward (``ops/fused_ce.py``)
    recomputes each chunk's logits block instead of stashing the [T, V]
    tensor — +2·T·D·V hardware FLOPs, identical model FLOPs; the
    replicated/dp/tp sharding variants all do the same global arithmetic."""
    d, T = d_model, batch * seq_len
    wk = _Walk()
    wk.params += vocab_size * d                   # tied embedding
    for _ in range(n_layers):
        _transformer_core(wk, T // batch, d, mlp_ratio * d, seq_len)
    wk.params += 2 * d                            # final layernorm
    # Head: tied embed.attend over the full sequence unfused; the fused
    # path projects only the seq_len-1 loss rows.
    head_rows = (seq_len - 1) if fused_ce else seq_len
    wk.dense(head_rows, d, vocab_size, params=False)
    recompute = 2.0 * (seq_len - 1) * d * vocab_size if fused_ce else 0.0
    return _finish(wk, batch, recompute_fwd=recompute)


def lm_step_cost_for(model: Any, batch: int, seq_len: int,
                     fused_ce_chunks: int = 0) -> StepCost:
    """The LM cost of the port's ``TransformerLM`` (its constructor's
    ``config``: the whole model's widths, under TP and FSDP too)."""
    cfg = model.config
    return lm_step_cost(
        vocab_size=int(cfg["vocab_size"]),
        d_model=int(cfg["d_model"]),
        n_layers=int(cfg["n_layers"]),
        batch=batch,
        seq_len=seq_len,
        fused_ce=bool(fused_ce_chunks),
    )


# ------------------------------------------------------------ counted FLOPs
def _valid_conv_flops(x_shape, w_shape, stride, padding, dilation, groups) -> int:
    """2 x multiply-adds of an NCHW convolution over in-bounds taps only."""
    n, cin = int(x_shape[0]), int(x_shape[1])
    cout, ks = int(w_shape[0]), [int(k) for k in w_shape[2:]]
    taps = 1
    for d, k in enumerate(ks):
        size, s, p, dl = int(x_shape[2 + d]), stride[d], padding[d], dilation[d]
        out = (size + 2 * p - dl * (k - 1) - 1) // s + 1
        taps *= sum(1 for o in range(out) for t in range(k) if 0 <= o * s - p + t * dl < size)
    return 2 * n * cout * (cin // groups) * taps


def _conv_formula(x_shape, w_shape, _bias, stride, padding, dilation, transposed,
                  _output_padding=None, groups=1, *_, **__) -> int:
    if transposed:
        raise ValueError("counted_step_flops: transposed convolutions have no valid-tap "
                         "formula here")
    return _valid_conv_flops(x_shape, w_shape, stride, padding, dilation, groups)


def _conv_backward_formula(_grad_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                           transposed, _output_padding, groups, output_mask, *_, **__) -> int:
    one = _conv_formula(x_shape, w_shape, None, stride, padding, dilation, transposed,
                        None, groups)
    return one * (int(output_mask[0]) + int(output_mask[1]))


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def counted_step_flops(step: Callable, *args) -> float:
    """FLOPs of one call ``step(*args)`` as ``FlopCounterMode`` counts them
    (matmuls and convolutions, convolutions over valid taps only): the
    cross-check the analytic models are tested against, as the JAX
    package's ``xla_step_flops``.  The call runs (a train step updates its
    model once).  CPU tensors only: on a card, K1-K5 are launches the
    counter cannot see, so a CUDA tensor among ``args`` raises."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    if any(t.is_cuda for t in _tensors(args)):
        raise ValueError("counted_step_flops counts the CPU path, where K1-K5's wrappers run "
                         "their plain versions; the counter cannot see the CUDA kernels' "
                         "launches: pass CPU tensors")
    aten = torch.ops.aten
    mapping = {aten.convolution: _conv_formula,
               aten.convolution_backward: _conv_backward_formula}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        step(*args)
    return float(counter.get_total_flops())


# ----------------------------------------------------------- memory estimates
@dataclasses.dataclass(frozen=True)
class MemCost:
    """Analytic per-device peak-HBM model for one train step.

    What the state layout and activation schedule *should* keep resident
    at the step's high-water mark.  The accounting is the JAX package's,
    which mirrors XLA's ``memory_analysis()`` naive temp + argument +
    output sum (donated buffers counted on both sides); on the card the
    caching allocator's peak (``torch.cuda.max_memory_allocated``) is the
    measurement to hold it against.
    """

    argument_bytes: float
    output_bytes: float
    temp_bytes: float
    breakdown: Dict[str, float]

    @property
    def peak_bytes(self) -> float:
        return self.argument_bytes + self.output_bytes + self.temp_bytes


def train_mem_peak(param_bytes: float, act_bytes: float,
                   data_bytes: float = 0.0, *, dp: int = 4,
                   zero: bool = False, explicit_sync: bool = True,
                   metric_bytes: float = 128.0) -> MemCost:
    """Generic train-step peak-HBM model from first principles:

    - **arguments**: params + momentum + the per-device batch shard.
      Under ``--zero wus`` the momentum tree lives as owned 1/dp chunks.
    - **outputs**: the new state (same layout) + the scalar metrics
      tuple.  Donation aliases outputs onto arguments, but the compiler's
      accounting (and so the ledger's) books both sides — so does this.
    - **temps**: the gradient tree (one param-tree copy, live from
      backward until the update consumes it) + the live activation /
      saved-residual bytes at the backward peak.  ``explicit_sync`` adds
      the hand-written grad-sync path's materialized scratch: one synced
      tree for the all-reduce (or the gathered delta under zero), plus
      the owned-chunk stack between the reduce-scatter and all-gather
      hops.  GSPMD steps sync in place — pass ``explicit_sync=False``.
    """
    dp = max(1, int(dp))
    momentum = param_bytes / dp if zero else param_bytes
    state = param_bytes + momentum
    grads = param_bytes
    sync = 0.0
    if explicit_sync and dp > 1:
        sync = param_bytes + (param_bytes / dp if zero else 0.0)
    temp = grads + act_bytes + sync
    return MemCost(
        argument_bytes=state + data_bytes,
        output_bytes=state + metric_bytes,
        temp_bytes=temp,
        breakdown={"params": param_bytes, "momentum": momentum,
                   "data": data_bytes, "grads": grads,
                   "activations": act_bytes, "grad_sync_scratch": sync,
                   "metrics": metric_bytes})


def lm_act_bytes(d_model: int, n_layers: int, n_heads: int, batch: int,
                 seq_len: int, vocab_size: int, *, dp: int = 4,
                 mlp_ratio: int = 4, elem: float = 4.0) -> float:
    """Live activation/saved-residual bytes at the LM backward peak, per
    device (``b = batch/dp`` rows).  Per layer per token the autodiff
    schedule stashes ~9 d-wide tensors (ln1, qkv, attn out, proj out,
    two residual adds, ln2, fc2 out) + 2 mlp-wide (fc1 out, gelu out) +
    the two [H, T, T] score/softmax matrices; the loss head holds the
    logits block plus ~2x for log-softmax and its gradient."""
    b = batch / max(1, int(dp))
    per_token = 9.0 * d_model + 2.0 * mlp_ratio * d_model
    scores = 2.0 * n_heads * seq_len
    stack = b * seq_len * n_layers * (per_token + scores)
    head = 3.0 * b * seq_len * vocab_size
    return elem * (stack + head)


def lm_train_mem_peak(vocab_size: int, d_model: int, n_layers: int,
                      n_heads: int, batch: int, seq_len: int, *,
                      dp: int = 4, zero: bool = False,
                      mlp_ratio: int = 4) -> MemCost:
    """Analytic peak HBM for the GSPMD transformer-LM train step: tied
    embedding + block stack params (f32), momentum (1/dp-sharded under
    ``--zero wus``), the lm_act_bytes schedule, int32 token shard.
    GSPMD derives the grad sync in place, so no explicit scratch term."""
    params = lm_step_cost(vocab_size, d_model, n_layers, batch,
                          seq_len, mlp_ratio=mlp_ratio).params
    act = lm_act_bytes(d_model, n_layers, n_heads, batch, seq_len,
                       vocab_size, dp=dp, mlp_ratio=mlp_ratio)
    tokens = 4.0 * (batch / max(1, dp)) * seq_len + 8.0  # int32 + lr/step
    return train_mem_peak(4.0 * params, act, data_bytes=tokens, dp=dp,
                          zero=zero, explicit_sync=False,
                          metric_bytes=256.0)


# ------------------------------------------------------------------ reporter
class MFUReporter:
    """Turns host-measured step seconds into per-step MFU/HFU fields for
    the metrics JSONL (all-host math — never touches the device).
    ``peak_per_chip`` None: ``device_peak_flops()`` of the current card."""

    def __init__(self, cost: StepCost, n_devices: int,
                 peak_per_chip: Optional[float] = None):
        self.cost = cost
        self.n_devices = max(1, int(n_devices))
        self.peak = (peak_per_chip if peak_per_chip is not None
                     else device_peak_flops())
        self._denom = self.peak * self.n_devices

    def fields(self, step_time: float) -> Dict[str, float]:
        dt = max(float(step_time), 1e-9)
        return {
            "mfu": 100.0 * self.cost.model_flops / dt / self._denom,
            "hfu": 100.0 * self.cost.hardware_flops / dt / self._denom,
            "model_tflops": self.cost.model_flops / dt / 1e12,
        }
