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
A tree quantized by ``quantize_lm_params`` (either package's) carries
``w_q`` int8 [in, out] and ``scale`` f32 [out] in place of a block kernel;
they become ``...w_q`` int8 [out, in] and ``...scale``, the buffers of the
port's ``QuantDense``.

``resnet_state_dict_from_jax`` does the same for a ``ResNet``'s ``params``
and ``batch_stats`` with torchvision's names, which the JAX package's
``utils/torch_import.py::import_resnet_state_dict`` reads back: ``conv1``,
``bn1``, ``layer{s}.{i}.conv{k}`` / ``bn{k}``, ``downsample.0`` / ``.1``,
``fc``.  Conv kernels go from HWIO to OIHW; BN ``scale``/``bias`` become
``weight``/``bias`` and ``mean``/``var`` the running statistics.  Both take
an optional ``device``: each array then goes to it as it is (no host copy
of an f32 array) and is transposed there.

The inverse converters, ``lm_params_to_jax`` and
``resnet_variables_to_jax``, give back the JAX trees the JAX package's
``import_lm_state_dict`` and ``import_resnet_state_dict`` make of the same
``state_dict`` (host f32 numpy, keys sorted at every level as
``jax.tree_util`` leaves them, so a checkpoint written from them has the JAX
package's key order).  ``momentum_state_dict`` names ``torch.optim.SGD``'s
momentum buffers as the parameters they belong to, zeros where no step has
made one yet: JAX's ``sgd_init`` starts from zeros and ``buf = mu * 0 + g``
is torch's first buffer, so both agree; the same converters then map them.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if device is None:
        return torch.from_numpy(np.array(x, dtype=np.float32))
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)


def lm_state_dict_from_jax(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` params → the port's ``state_dict`` (f32, on the
    CPU unless ``device`` names another)."""
    blocks = sorted((k for k in params if re.fullmatch(r"block_\d+", k)),
                    key=lambda k: int(k.split("_")[1]))
    if [int(k.split("_")[1]) for k in blocks] != list(range(len(blocks))):
        raise ValueError(f"non-contiguous block indices: {blocks}")

    def t(x):
        return _t(x, device)

    def kernel(pre, p):
        if "w_q" in p:  # int8 weight-only (models/quant.py)
            w_q = torch.from_numpy(np.array(p["w_q"], dtype=np.int8))
            sd[f"{pre}.w_q"] = w_q.to(device or "cpu").T.contiguous()
            sd[f"{pre}.scale"] = t(p["scale"])
        else:
            sd[f"{pre}.weight"] = t(p["kernel"]).T.contiguous()

    sd = {"embed.weight": t(params["embed"]["embedding"])}
    for i, name in enumerate(blocks):
        p, pre = params[name], f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{pre}.{ln}.weight"] = t(p[ln]["scale"])
            sd[f"{pre}.{ln}.bias"] = t(p[ln]["bias"])
        for lin in ("qkv", "proj"):
            kernel(f"{pre}.attn.{lin}", p["attn"][lin])
        for fc in ("fc1", "fc2"):
            kernel(f"{pre}.{fc}", p[fc])
            sd[f"{pre}.{fc}.bias"] = t(p[fc]["bias"])
    sd["ln_f.weight"] = t(params["ln_f"]["scale"])
    sd["ln_f.bias"] = t(params["ln_f"]["bias"])
    return sd


def _conv(kernel, device=None) -> torch.Tensor:
    return _t(kernel, device).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping,
        stats: Optional[Mapping], device=None) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"], device)
    sd[f"{prefix}.bias"] = _t(params["bias"], device)
    if stats is not None:
        sd[f"{prefix}.running_mean"] = _t(stats["mean"], device)
        sd[f"{prefix}.running_var"] = _t(stats["var"], device)


def resnet_state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping],
                               device=None) -> Dict[str, torch.Tensor]:
    """JAX ``ResNet`` params and batch_stats -> the port's ``state_dict``
    (the parameters alone when ``batch_stats`` is None, e.g. a momentum
    tree).

    The JAX tree numbers blocks globally (``Bottleneck_0``, ...); a new
    stage starts where a block's output width changes (each stage doubles
    it)."""
    kinds = {"Bottleneck": 3, "BasicBlock": 2}
    matches = ((k, re.fullmatch(r"(Bottleneck|BasicBlock)_(\d+)", k)) for k in params)
    blocks = sorted(((k, m) for k, m in matches if m), key=lambda km: int(km[1].group(2)))
    if [int(m.group(2)) for _, m in blocks] != list(range(len(blocks))):
        raise ValueError(f"non-contiguous block indices: {[k for k, _ in blocks]}")
    sd = {"conv1.weight": _conv(params["conv_init"]["kernel"], device)}
    _bn(sd, "bn1", params["bn_init"], None if batch_stats is None else batch_stats["bn_init"],
        device)
    stage, index, width = 0, 0, None
    for name, m in blocks:
        p, n_convs = params[name], kinds[m.group(1)]

        def st(key):
            return None if batch_stats is None else batch_stats[name][key]

        out = np.shape(p[f"Conv_{n_convs - 1}"]["kernel"])[-1]
        if out != width:
            stage, index, width = stage + 1, 0, out
        t = f"layer{stage}.{index}"
        for c in range(n_convs):
            sd[f"{t}.conv{c + 1}.weight"] = _conv(p[f"Conv_{c}"]["kernel"], device)
            _bn(sd, f"{t}.bn{c + 1}", p[f"FusedBatchNormAct_{c}"],
                st(f"FusedBatchNormAct_{c}"), device)
        if f"Conv_{n_convs}" in p:
            sd[f"{t}.downsample.0.weight"] = _conv(p[f"Conv_{n_convs}"]["kernel"], device)
            _bn(sd, f"{t}.downsample.1", p[f"FusedBatchNormAct_{n_convs}"],
                st(f"FusedBatchNormAct_{n_convs}"), device)
        index += 1
    sd["fc.weight"] = _t(params["fc"]["kernel"], device).T.contiguous()
    sd["fc.bias"] = _t(params["fc"]["bias"], device)
    return sd


# ------------------------------------------------------------ port -> JAX

def _h(t: torch.Tensor) -> np.ndarray:
    """A host f32 C-ordered numpy copy of ``t``: a transposed view is laid out
    on its own device first, so the card does the transpose and the host
    takes one contiguous copy."""
    t = t.detach().to(torch.float32).contiguous()
    return t.to("cpu", copy=True).numpy()


def _sorted(tree):
    """Keys sorted at every level, the order ``jax.tree_util`` rebuilds
    dicts in (and so the order of every tree in a JAX checkpoint)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _strip(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


def lm_params_to_jax(state_dict: Mapping) -> Dict:
    """The port's (or any GPT-style) LM ``state_dict`` → the JAX
    ``TransformerLM`` params tree; the inverse of ``lm_state_dict_from_jax``.
    Linear weights are transposed on their own device before the copy to
    the host."""
    sd = _strip(state_dict)
    if "embed.weight" not in sd:
        raise ValueError(f"not an LM state_dict: missing 'embed.weight' "
                         f"(got keys like {sorted(sd)[:3]}...)")
    layers = sorted({int(m.group(1)) for k in sd for m in [re.match(r"blocks\.(\d+)\.", k)]
                     if m})
    if layers != list(range(len(layers))):
        raise ValueError(f"non-contiguous block indices: {layers}")

    def ln(pre):
        return {"scale": _h(sd[f"{pre}.weight"]), "bias": _h(sd[f"{pre}.bias"])}

    def linear(pre, bias=True):
        out = {"kernel": _h(sd[f"{pre}.weight"].T)}
        if bias:
            out["bias"] = _h(sd[f"{pre}.bias"])
        return out

    params = {"embed": {"embedding": _h(sd["embed.weight"])}, "ln_f": ln("ln_f")}
    for i in layers:
        pre = f"blocks.{i}"
        params[f"block_{i}"] = {
            "ln1": ln(f"{pre}.ln1"), "ln2": ln(f"{pre}.ln2"),
            "attn": {"qkv": linear(f"{pre}.attn.qkv", bias=False),
                     "proj": linear(f"{pre}.attn.proj", bias=False)},
            "fc1": linear(f"{pre}.fc1"), "fc2": linear(f"{pre}.fc2")}
    return _sorted(params)


def _resnet_tree(sd: Dict[str, torch.Tensor], stats: bool) -> Dict:
    """ResNet params (``stats=False``) or batch_stats (``stats=True``) in the
    JAX tree, the structure read off the torchvision names."""
    if "conv1.weight" not in sd:
        raise ValueError(f"not a ResNet state_dict: missing 'conv1.weight' "
                         f"(got keys like {sorted(sd)[:3]}...)")

    def conv(key):
        return {"kernel": _h(sd[key].permute(2, 3, 1, 0))}   # OIHW -> HWIO

    def bn(pre):
        if stats:
            return {"mean": _h(sd[f"{pre}.running_mean"]), "var": _h(sd[f"{pre}.running_var"])}
        return {"scale": _h(sd[f"{pre}.weight"]), "bias": _h(sd[f"{pre}.bias"])}

    stages: Dict[int, int] = {}
    for k in sd:
        m = re.match(r"layer(\d+)\.(\d+)\.conv1\.weight$", k)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            stages[s] = max(stages.get(s, 0), i + 1)
    if sorted(stages) != list(range(1, len(stages) + 1)):
        raise ValueError(f"non-contiguous layer indices: {sorted(stages)}")
    n_convs = 3 if "layer1.0.conv3.weight" in sd else 2
    kind = "Bottleneck" if n_convs == 3 else "BasicBlock"
    tree = {"bn_init": bn("bn1")}
    if not stats:
        tree["conv_init"] = conv("conv1.weight")
        tree["fc"] = {"kernel": _h(sd["fc.weight"].T), "bias": _h(sd["fc.bias"])}
    k = 0
    for s in sorted(stages):
        for i in range(stages[s]):
            pre, block = f"layer{s}.{i}", {}
            for c in range(n_convs):
                block[f"FusedBatchNormAct_{c}"] = bn(f"{pre}.bn{c + 1}")
                if not stats:
                    block[f"Conv_{c}"] = conv(f"{pre}.conv{c + 1}.weight")
            if f"{pre}.downsample.0.weight" in sd:
                block[f"FusedBatchNormAct_{n_convs}"] = bn(f"{pre}.downsample.1")
                if not stats:
                    block[f"Conv_{n_convs}"] = conv(f"{pre}.downsample.0.weight")
            tree[f"{kind}_{k}"] = block
            k += 1
    return _sorted(tree)


def resnet_params_to_jax(state_dict: Mapping) -> Dict:
    """A ResNet's parameters alone (no running statistics needed: a
    momentum ``state_dict``) → the JAX ``params`` tree."""
    return _resnet_tree(_strip(state_dict), stats=False)


def resnet_variables_to_jax(state_dict: Mapping) -> Dict[str, Dict]:
    """The port's ResNet ``state_dict`` → ``{"params", "batch_stats"}``; the
    inverse of ``resnet_state_dict_from_jax``."""
    sd = _strip(state_dict)
    return {"params": _resnet_tree(sd, stats=False), "batch_stats": _resnet_tree(sd, stats=True)}


def momentum_state_dict(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer]
                        ) -> Dict[str, torch.Tensor]:
    """``{parameter name: its SGD momentum buffer}``, zeros for a parameter
    with no buffer yet (no step taken, or no optimizer)."""
    state = optimizer.state if optimizer is not None else {}
    out = {}
    for name, p in model.named_parameters():
        buf = state.get(p, {}).get("momentum_buffer")
        out[name] = buf if buf is not None else torch.zeros_like(p)
    return out
