"""Weight carry-over from the JAX package's LM to the port.

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
