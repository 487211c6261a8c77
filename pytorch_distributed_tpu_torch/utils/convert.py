"""Weight carry-over from the JAX package's models to the port.

``lm_state_dict_from_jax`` turns a ``TransformerLM`` ``params`` tree (numpy
arrays, or anything ``np.asarray`` takes) into the port's ``state_dict``.
The names are the GPT-style ones that the JAX package's
``utils/torch_import.py::import_lm_state_dict`` reads, so that function maps
the port's ``state_dict`` straight back:

- ``embed.weight``                      [V, C]   (output head tied to it)
- ``blocks.{i}.ln1|ln2.weight/bias``    LayerNorm
- ``blocks.{i}.attn.qkv.weight``        [3C, C]  (no bias)
- ``blocks.{i}.attn.proj.weight``       [C, C]   (no bias)
- ``blocks.{i}.fc1.weight/bias``        [4C, C]
- ``blocks.{i}.fc2.weight/bias``        [C, 4C]
- ``ln_f.weight/bias``                  final LayerNorm

flax Dense kernels are stored [in, out]; torch Linear weights are [out, in].

``resnet_state_dict_from_jax`` does the same for a ``ResNet``'s ``params``
and ``batch_stats`` with torchvision's names, which the JAX package's
``utils/torch_import.py::import_resnet_state_dict`` reads back: ``conv1``,
``bn1``, ``layer{s}.{i}.conv{k}`` / ``bn{k}``, ``downsample.0`` / ``.1``,
``fc``.  Conv kernels go from HWIO to OIHW; BN ``scale``/``bias`` become
``weight``/``bias`` and ``mean``/``var`` the running statistics.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def lm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` params → the port's ``state_dict`` (f32, CPU)."""
    blocks = sorted((k for k in params if re.fullmatch(r"block_\d+", k)),
                    key=lambda k: int(k.split("_")[1]))
    if [int(k.split("_")[1]) for k in blocks] != list(range(len(blocks))):
        raise ValueError(f"non-contiguous block indices: {blocks}")
    sd = {"embed.weight": _t(params["embed"]["embedding"])}
    for i, name in enumerate(blocks):
        p, t = params[name], f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{t}.{ln}.weight"] = _t(p[ln]["scale"])
            sd[f"{t}.{ln}.bias"] = _t(p[ln]["bias"])
        for lin in ("qkv", "proj"):
            sd[f"{t}.attn.{lin}.weight"] = _t(p["attn"][lin]["kernel"]).T.contiguous()
        for fc in ("fc1", "fc2"):
            sd[f"{t}.{fc}.weight"] = _t(p[fc]["kernel"]).T.contiguous()
            sd[f"{t}.{fc}.bias"] = _t(p[fc]["bias"])
    sd["ln_f.weight"] = _t(params["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(params["ln_f"]["bias"])
    return sd


def _conv(kernel) -> torch.Tensor:
    return _t(kernel).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def resnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``ResNet`` params and batch_stats -> the port's ``state_dict``.

    The JAX tree numbers blocks globally (``Bottleneck_0``, ...); a new
    stage starts where a block's output width changes (each stage doubles
    it)."""
    kinds = {"Bottleneck": 3, "BasicBlock": 2}
    matches = ((k, re.fullmatch(r"(Bottleneck|BasicBlock)_(\d+)", k)) for k in params)
    blocks = sorted(((k, m) for k, m in matches if m), key=lambda km: int(km[1].group(2)))
    if [int(m.group(2)) for _, m in blocks] != list(range(len(blocks))):
        raise ValueError(f"non-contiguous block indices: {[k for k, _ in blocks]}")
    sd = {"conv1.weight": _conv(params["conv_init"]["kernel"])}
    _bn(sd, "bn1", params["bn_init"], batch_stats["bn_init"])
    stage, index, width = 0, 0, None
    for name, m in blocks:
        p, st, n_convs = params[name], batch_stats[name], kinds[m.group(1)]
        out = np.shape(p[f"Conv_{n_convs - 1}"]["kernel"])[-1]
        if out != width:
            stage, index, width = stage + 1, 0, out
        t = f"layer{stage}.{index}"
        for c in range(n_convs):
            sd[f"{t}.conv{c + 1}.weight"] = _conv(p[f"Conv_{c}"]["kernel"])
            _bn(sd, f"{t}.bn{c + 1}", p[f"FusedBatchNormAct_{c}"],
                st[f"FusedBatchNormAct_{c}"])
        if f"Conv_{n_convs}" in p:
            sd[f"{t}.downsample.0.weight"] = _conv(p[f"Conv_{n_convs}"]["kernel"])
            _bn(sd, f"{t}.downsample.1", p[f"FusedBatchNormAct_{n_convs}"],
                st[f"FusedBatchNormAct_{n_convs}"])
        index += 1
    sd["fc.weight"] = _t(params["fc"]["kernel"]).T.contiguous()
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd
