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
package's key order).  Both directions, ``jax_leaves`` (a model's
parameters in the JAX flatten order, for the gradient collectives) and the
gradient-communication state in checkpoints read one table: ``JaxLeaf``,
each torch name's JAX path and layout (``_lm_leaf``, ``_resnet_leaves``).
``momentum_state_dict`` names ``torch.optim.SGD``'s momentum buffers as the
parameters they belong to, zeros where no step has made one yet: JAX's
``sgd_init`` starts from zeros and ``buf = mu * 0 + g`` is torch's first
buffer, so both agree; the same converters then map them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if device is None:
        return torch.from_numpy(np.array(x, dtype=np.float32))
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)


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


def tree_from_leaves(paths, values) -> Dict:
    """The nested dict (keys sorted at every level) with ``values`` at
    ``paths``: a JAX-layout tree of the leaves ``jax_leaves`` lists."""
    tree: Dict = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return _sorted(tree)


def tree_at(tree: Mapping, path) -> object:
    """The value at ``path`` of a nested mapping."""
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------- the table

@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One torch tensor as a leaf of a JAX tree: its ``path`` of keys there
    (in ``params``, or in ``batch_stats`` for the ``mean``/``var`` leaves),
    the port's ``name``, and ``perm``, the dimension order that views the
    torch tensor in the JAX layout (None: the same)."""

    path: Tuple[str, ...]
    name: str
    perm: Optional[Tuple[int, ...]] = None

    @property
    def is_stat(self) -> bool:
        return self.path[-1] in ("mean", "var")

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (this parameter's torch layout) viewed in the JAX layout."""
        return t if self.perm is None else t.permute(self.perm)

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the JAX layout) viewed in this parameter's torch layout."""
        if self.perm is None:
            return t
        inv = [0] * len(self.perm)
        for i, d in enumerate(self.perm):
            inv[d] = i
        return t.permute(inv)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as the JAX tree's host f32 array."""
        return _h(self.to_jax(t))

    def from_host(self, x, device=None) -> torch.Tensor:
        """A JAX tree's array as this tensor (f32, on ``device``)."""
        t = _t(x, device)
        return t if self.perm is None else self.from_jax(t).contiguous()


_HWIO = (2, 3, 1, 0)   # OIHW -> HWIO
_IO = (1, 0)           # [out, in] -> [in, out]
_NORM = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _lm_names(n_layers: int) -> List[str]:
    """A ``TransformerLM``'s parameter names, in its registration order."""
    names = ["embed.weight"]
    for i in range(n_layers):
        pre = f"blocks.{i}"
        names += [f"{pre}.ln1.weight", f"{pre}.ln1.bias", f"{pre}.attn.qkv.weight",
                  f"{pre}.attn.proj.weight", f"{pre}.ln2.weight", f"{pre}.ln2.bias",
                  f"{pre}.fc1.weight", f"{pre}.fc1.bias", f"{pre}.fc2.weight", f"{pre}.fc2.bias"]
    return names + ["ln_f.weight", "ln_f.bias"]


def _lm_leaf(name: str) -> JaxLeaf:
    parts = name.split(".")
    if name == "embed.weight":
        return JaxLeaf(("embed", "embedding"), name)
    if parts[0] == "ln_f":
        return JaxLeaf(("ln_f", _NORM[parts[1]]), name)
    block = f"block_{parts[1]}"
    if parts[2] in ("ln1", "ln2"):
        return JaxLeaf((block, parts[2], _NORM[parts[3]]), name)
    if parts[2] == "attn":
        return JaxLeaf((block, "attn", parts[3], "kernel"), name, _IO)
    if parts[3] == "weight":
        return JaxLeaf((block, parts[2], "kernel"), name, _IO)
    return JaxLeaf((block, parts[2], "bias"), name)


def _resnet_names(blocks: List[Tuple[int, int, bool]], n_convs: int, stats: bool) -> List[str]:
    """The torchvision names of a ResNet of ``blocks`` ``(stage, index,
    has_downsample)``, with the BatchNorm running statistics when
    ``stats``, in the model's registration order."""
    norm = ["weight", "bias"] + (["running_mean", "running_var"] if stats else [])
    names = ["conv1.weight"] + [f"bn1.{k}" for k in norm]
    for s, i, down in blocks:
        pre = f"layer{s}.{i}"
        for c in range(1, n_convs + 1):
            names += [f"{pre}.conv{c}.weight"] + [f"{pre}.bn{c}.{k}" for k in norm]
        if down:
            names += [f"{pre}.downsample.0.weight"] + [f"{pre}.downsample.1.{k}" for k in norm]
    return names + ["fc.weight", "fc.bias"]


def _resnet_leaves(names: List[str]) -> List[JaxLeaf]:
    """The leaf of every ResNet name: blocks are numbered globally in
    (stage, index) order, as the JAX model numbers them."""
    n_convs = 3 if "layer1.0.conv3.weight" in names else 2
    kind = "Bottleneck" if n_convs == 3 else "BasicBlock"
    blocks = sorted({(int(m.group(1)), int(m.group(2))) for n in names
                     for m in [re.match(r"layer(\d+)\.(\d+)\.", n)] if m})
    index = {b: k for k, b in enumerate(blocks)}
    out = []
    for n in names:
        parts = n.split(".")
        if n == "conv1.weight":
            out.append(JaxLeaf(("conv_init", "kernel"), n, _HWIO))
        elif parts[0] == "bn1":
            out.append(JaxLeaf(("bn_init", _NORM[parts[1]]), n))
        elif n == "fc.weight":
            out.append(JaxLeaf(("fc", "kernel"), n, _IO))
        elif n == "fc.bias":
            out.append(JaxLeaf(("fc", "bias"), n))
        else:
            block = f"{kind}_{index[(int(parts[0][5:]), int(parts[1]))]}"
            if parts[2] == "downsample":
                c, is_conv, key = n_convs, parts[3] == "0", parts[-1]
            else:
                c, is_conv, key = int(parts[2][-1]) - 1, parts[2].startswith("conv"), parts[3]
            if is_conv:
                out.append(JaxLeaf((block, f"Conv_{c}", "kernel"), n, _HWIO))
            else:
                out.append(JaxLeaf((block, f"FusedBatchNormAct_{c}", _NORM[key]), n))
    return out


def jax_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """The model's parameters as the leaves of its JAX ``params`` tree, in
    ``jax.tree_util``'s flatten order (dict keys sorted at every level, so
    ``block_10`` comes before ``block_2``): the order and the layouts the
    JAX package's gradient collectives, buckets and checkpoints see."""
    names = [n for n, _ in model.named_parameters()]
    if "embed.weight" in names:
        leaves = [_lm_leaf(n) for n in names]
    elif "conv1.weight" in names:
        leaves = _resnet_leaves(names)
    else:
        raise ValueError("the JAX leaf order covers the TransformerLM (embed.weight) and the "
                         f"ResNet family (conv1.weight); got names like {names[:3]}")
    return sorted(leaves, key=lambda leaf: leaf.path)


def _tree(sd: Mapping, leaves: List[JaxLeaf]) -> Dict:
    return tree_from_leaves([leaf.path for leaf in leaves],
                            [leaf.to_host(sd[leaf.name]) for leaf in leaves])


# ------------------------------------------------------------ JAX -> port

def lm_state_dict_from_jax(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` params → the port's ``state_dict`` (f32, on the
    CPU unless ``device`` names another)."""
    blocks = sorted((k for k in params if re.fullmatch(r"block_\d+", k)),
                    key=lambda k: int(k.split("_")[1]))
    if [int(k.split("_")[1]) for k in blocks] != list(range(len(blocks))):
        raise ValueError(f"non-contiguous block indices: {blocks}")
    sd = {}
    for leaf in map(_lm_leaf, _lm_names(len(blocks))):
        parent = tree_at(params, leaf.path[:-1])
        if leaf.path[-1] == "kernel" and "w_q" in parent:  # int8 weight-only (models/quant.py)
            pre = leaf.name[:-len(".weight")]
            w_q = torch.from_numpy(np.array(parent["w_q"], dtype=np.int8))
            sd[f"{pre}.w_q"] = w_q.to(device or "cpu").T.contiguous()
            sd[f"{pre}.scale"] = _t(parent["scale"], device)
        else:
            sd[leaf.name] = leaf.from_host(parent[leaf.path[-1]], device)
    return sd


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
    n_convs = kinds[blocks[0][1].group(1)] if blocks else 2
    spec, stage, index, width = [], 0, None, None
    for name, _ in blocks:
        out = np.shape(params[name][f"Conv_{n_convs - 1}"]["kernel"])[-1]
        if out != width:
            stage, index, width = stage + 1, 0, out
        spec.append((stage, index, f"Conv_{n_convs}" in params[name]))
        index += 1
    sd = {}
    for leaf in _resnet_leaves(_resnet_names(spec, n_convs, batch_stats is not None)):
        tree = batch_stats if leaf.is_stat else params
        sd[leaf.name] = leaf.from_host(tree_at(tree, leaf.path), device)
    return sd


# ------------------------------------------------------------ port -> JAX

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
    return _tree(sd, [_lm_leaf(n) for n in _lm_names(len(layers))])


def _resnet_tree(sd: Dict[str, torch.Tensor], stats: bool) -> Dict:
    """ResNet params (``stats=False``) or batch_stats (``stats=True``) in the
    JAX tree, the structure read off the torchvision names."""
    if "conv1.weight" not in sd:
        raise ValueError(f"not a ResNet state_dict: missing 'conv1.weight' "
                         f"(got keys like {sorted(sd)[:3]}...)")
    stages: Dict[int, int] = {}
    for k in sd:
        m = re.match(r"layer(\d+)\.(\d+)\.conv1\.weight$", k)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            stages[s] = max(stages.get(s, 0), i + 1)
    if sorted(stages) != list(range(1, len(stages) + 1)):
        raise ValueError(f"non-contiguous layer indices: {sorted(stages)}")
    n_convs = 3 if "layer1.0.conv3.weight" in sd else 2
    spec = [(s, i, f"layer{s}.{i}.downsample.0.weight" in sd)
            for s in sorted(stages) for i in range(stages[s])]
    leaves = _resnet_leaves(_resnet_names(spec, n_convs, stats))
    return _tree(sd, [leaf for leaf in leaves if leaf.is_stat == stats])


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
