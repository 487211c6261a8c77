"""Int8 weight-only quantization for LM serving, the port of
``pytorch_distributed_tpu/models/quant.py``.

Block Dense kernels (``QUANT_MODULES``: attention ``qkv``/``proj``, MLP
``fc1``/``fc2``) are stored int8 with per-output-channel symmetric f32
scales; the embedding (also the tied head) and the norms stay full
precision.  Post-training and weight-only: no calibration, activations in
the compute dtype.

- ``quantize_kernel`` and ``quantize_lm_params``: numpy copies of the JAX
  functions, bit for bit (f32 scales ``max|w| / 127``, an all-zero channel
  scaled by 1, ``np.round`` half to even, the clip to ±127), over the JAX
  package's params tree (``kernel [in, out]`` → ``w_q`` + ``scale``).
- ``QuantDense``: the module.  Its ``w_q`` buffer is int8 in the port's
  ``[out, in]`` layout (``utils/convert.py`` owns the transpose), ``scale``
  an f32 ``[out]`` buffer, and ``y = (x @ w_q.to(dtype)ᵀ) * scale (+ bias)``
  in the module dtype, as the JAX module computes it.
- ``quantize_state_dict`` and ``quantize_lm``: the same conversion for the
  port's own ``TransformerLM`` state dict and model, through the JAX-layout
  tree (``utils/convert.py``), so both packages quantize the same numbers.

Where XLA folds the int8→bf16 convert into the matmul's operand load,
``w_q.to(dtype)`` here writes a bf16 copy of each kernel at each call: the
weights' device memory is halved (int8), their traffic per call is not.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.utils.convert import lm_params_to_jax, lm_state_dict_from_jax

# Block Dense modules that stream the bulk of the parameter bytes per
# decoded token (SelfAttention qkv/proj, MLP fc1/fc2).
QUANT_MODULES = ("qkv", "proj", "fc1", "fc2")
QUANT_MODES = ("", "int8")


def check_quant(quant: str) -> str:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r} (expected '' or 'int8')")
    return quant


class QuantDense(nn.Module):
    """Dense over an int8 kernel with per-output-channel f32 scales:
    ``y = (x @ w_q.to(dtype)ᵀ) * scale [+ bias]``, the dequantized matmul
    with the kernel held in int8."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.register_buffer("w_q", torch.zeros(out_features, in_features, dtype=torch.int8,
                                                device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32,
                                                 device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype or dtype,
                                              device=device), requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.w_q.to(self.dtype))
        y = y * self.scale.to(y.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def block_linear(quant: str, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype, param_dtype: torch.dtype, device) -> nn.Module:
    """A block Dense: ``nn.Linear`` with ``param_dtype`` weights (the caller
    casts them to ``dtype`` at use), or ``QuantDense`` computing in
    ``dtype`` under ``quant="int8"``."""
    if check_quant(quant):
        return QuantDense(in_features, out_features, bias=bias, dtype=dtype,
                          param_dtype=param_dtype, device=device)
    return nn.Linear(in_features, out_features, bias=bias, dtype=param_dtype, device=device)


def quantize_kernel(kernel):
    """``[in, out]`` fp kernel -> (int8 ``w_q``, f32 per-out-channel scale),
    numpy."""
    w = np.asarray(kernel, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale)  # all-zero channels
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return w_q, scale.astype(np.float32)


def quantize_lm_params(params):
    """Convert a TransformerLM ``params`` tree (the JAX layout) for
    ``quant="int8"``: every 2-D ``kernel`` under a ``QUANT_MODULES`` scope
    becomes ``w_q`` + ``scale`` (bias, norms, embedding untouched).  Raises
    when it converts nothing."""
    converted = 0

    def walk(tree, name):
        nonlocal converted
        if not isinstance(tree, Mapping):
            return tree
        if (name in QUANT_MODULES and "kernel" in tree
                and getattr(tree["kernel"], "ndim", 0) == 2):
            w_q, scale = quantize_kernel(tree["kernel"])
            out = {k: v for k, v in tree.items() if k != "kernel"}
            out.update(w_q=w_q, scale=scale)
            converted += 1
            return out
        return {k: walk(v, k) for k, v in tree.items()}

    out = walk(dict(params), "")
    if converted == 0:
        raise ValueError(
            "quantize_lm_params converted no kernels — the tree has no "
            f"2-D 'kernel' under any of {QUANT_MODULES}; is this a "
            "TransformerLM params tree (or already quantized)?")
    return out


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor], device=None
                        ) -> Dict[str, torch.Tensor]:
    """A full-precision ``TransformerLM`` state dict -> the ``quant="int8"``
    one (f32 on ``device``, ``w_q`` int8), by ``quantize_lm_params`` on the
    JAX-layout tree."""
    return lm_state_dict_from_jax(quantize_lm_params(lm_params_to_jax(state_dict)),
                                  device=device)


@torch.no_grad()
def quantize_lm(model):
    """A ``TransformerLM(quant="int8")`` with ``model``'s shape, compute
    dtype and device holding the int8 conversion of its weights; the
    weights it keeps in full precision (embedding, biases) are stored in
    the compute dtype, the values every use casts them to."""
    if model.quant:
        raise ValueError(f"model is already quantized ({model.quant!r})")
    if getattr(model, "tp", 1) > 1 or getattr(model, "fsdp", None) is not None:
        raise ValueError("quantize the whole model, then shard it: a row-parallel shard's "
                         "channel scales are not the whole kernel's")
    qmodel = type(model)(**{**model.config, "quant": "int8", "param_dtype": model.dtype})
    qmodel.load_state_dict(quantize_state_dict(model.state_dict(), device=model.device))
    return qmodel.requires_grad_(False)
