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
The rest of the image zoo has a table per family (``_zoo_leaves``), read
off the model: torchvision's names (``features.{i}``, ``classifier.{i}``,
``features.denseblock{b}.denselayer{l}.norm1``, ...; the ViT's and the
Inceptions' are the JAX module's own), each flax layer either at the path
the family names or numbered as flax numbers an unnamed submodule
(``Conv_k``, ``BatchNorm_k``, ``Dense_k`` per kind, in call order, which the
port's registration order follows).  ViT's per-head kernels are ``[H, hd,
D]`` (query, key, value) and ``[D, H, hd]`` (out) here, ``[D, H, hd]`` and
``[H, hd, D]`` in JAX.  ``image_leaves`` covers every image model, the
ResNets included; ``image_state_dict_from_jax``, ``image_variables_to_jax``
and ``image_params_to_jax`` take the port's model or a registry name (then
built on the meta device for its names).
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

from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.models import densenet, extra, inception, mobilenet, simple
from pytorch_distributed_tpu_torch.models.layers import Dense
from pytorch_distributed_tpu_torch.models.resnet import Conv2d, ResNet
from pytorch_distributed_tpu_torch.models.vit import (HeadProjection, OutProjection,
                                                      VisionTransformer)
from pytorch_distributed_tpu_torch.ops.fused_bn import FusedBatchNormAct


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


_HEADS = (2, 0, 1)      # [H, hd, D] -> [D, H, hd] (ViT query / key / value kernels)
_OUT_HEADS = (1, 2, 0)  # [D, H, hd] -> [H, hd, D] (ViT attention output kernel)


_LEAF_KINDS = ((Conv2d, "Conv"), (FusedBatchNormAct, "BatchNorm"), (Dense, "Dense"),
               (torch.nn.LayerNorm, "LayerNorm"), (HeadProjection, "DenseGeneral"),
               (OutProjection, "DenseGeneral"))


def _module_leaves(name: str, mod: torch.nn.Module, path: Tuple[str, ...]) -> List[JaxLeaf]:
    """The leaves of one flax layer at ``path``: conv kernels HWIO, dense
    kernels [in, out], the ViT's head kernels, BatchNorm and LayerNorm
    ``scale``, BatchNorm statistics in ``batch_stats``."""
    kind = type(mod).__name__
    out = []
    for key, t in list(mod.named_parameters(recurse=False)) + list(
            mod.named_buffers(recurse=False)):
        leaf_name = f"{name}.{key}"
        if key in _NORM and kind in ("FusedBatchNormAct", "LayerNorm"):
            out.append(JaxLeaf(path + (_NORM[key],), leaf_name))
        elif key == "bias":
            out.append(JaxLeaf(path + ("bias",), leaf_name))
        else:
            perm = {"Conv2d": _HWIO, "Dense": _IO, "HeadProjection": _HEADS,
                    "OutProjection": _OUT_HEADS}[kind]
            out.append(JaxLeaf(path + ("kernel",), leaf_name, perm))
    return out


def _table(model: torch.nn.Module, scope_of, fixed=None) -> List[JaxLeaf]:
    """The leaves of a zoo model: each flax layer either at the path
    ``fixed(name)`` gives, or named as flax names an unnamed submodule,
    ``{Kind}_{k}`` counted per kind in call order (which the registration
    order follows) inside the scope ``scope_of(name)``."""
    counts: Dict[Tuple, int] = {}
    out = []
    for name, mod in model.named_modules():
        kind = next((k for cls, k in _LEAF_KINDS if isinstance(mod, cls)), None)
        if kind is None:
            continue
        path = fixed(name) if fixed is not None else None
        if path is None:
            scope = scope_of(name)
            k = counts.get((scope, kind), 0)
            counts[(scope, kind)] = k + 1
            path = scope + (f"{kind}_{k}",)
        out += _module_leaves(name, mod, path)
    return out


def _scope_index(prefixes: List[str], tag: str):
    """``scope_of`` for flax submodules ``{tag}_{k}`` numbered in model
    order: the k-th of ``prefixes`` (torch module names)."""
    def scope_of(name: str) -> Tuple[str, ...]:
        for k, pre in enumerate(prefixes):
            if name.startswith(pre + "."):
                return (f"{tag}_{k}",)
        return ()
    return scope_of


def _zoo_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """One table per family of the JAX zoo (torchvision's names; the ViT's
    and the Inceptions' are the JAX module's own)."""
    root = lambda name: ()  # noqa: E731
    if isinstance(model, (simple.AlexNet, simple.VGG)):
        head = f"classifier.{len(model.classifier) - 1}"
        return _table(model, root, lambda n: ("fc",) if n == head else None)
    if isinstance(model, densenet.DenseNet):
        def dense_scope(name):
            m = re.match(r"features\.denseblock(\d+)\.denselayer(\d+)\.", name)
            return (f"block{int(m.group(1)) - 1}_layer{int(m.group(2)) - 1}",) if m else ()
        return _table(model, dense_scope, lambda n: ("fc",) if n == "classifier" else None)
    if isinstance(model, mobilenet.MobileNetV2):
        blocks = [f"features.{i}.conv" for i, m in enumerate(model.features)
                  if isinstance(m, mobilenet.InvertedResidual)]
        return _table(model, _scope_index(blocks, "_InvertedResidual"),
                      lambda n: ("fc",) if n == "classifier.1" else None)
    if isinstance(model, extra.SqueezeNet):
        fires = [f"features.{i}" for i, m in enumerate(model.features)
                 if isinstance(m, extra.Fire)]
        return _table(model, _scope_index(fires, "_Fire"),
                      lambda n: ("classifier",) if n == "classifier.1" else None)
    if isinstance(model, extra.ShuffleNetV2):
        units = [f"stage{s}.{i}" for s in (2, 3, 4)
                 for i in range(len(getattr(model, f"stage{s}")))]
        return _table(model, _scope_index(units, "_ShuffleUnit"),
                      lambda n: ("fc",) if n == "fc" else None)
    if isinstance(model, extra.MNASNet):
        blocks = [f"layers.{i}.{j}" for i, m in enumerate(model.layers)
                  if isinstance(m, torch.nn.Sequential) for j in range(len(m))]
        return _table(model, _scope_index(blocks, "_MBConv"),
                      lambda n: ("fc",) if n == "classifier.1" else None)
    if isinstance(model, (inception.GoogLeNet, inception.InceptionV3)):
        # torch's branch2.1 is flax's branch2_1; every other name is flax's.
        return _table(model, root,
                      lambda n: tuple(re.sub(r"(branch\d)\.(\d)", r"\1_\2", n).split(".")))
    if isinstance(model, VisionTransformer):
        own = [JaxLeaf((n,), n) for n in ("cls_token", "pos_embedding", "cls_pos_embedding")]
        return own + _table(model, root, lambda n: tuple(n.split(".")))
    raise ValueError(f"no JAX leaf table for {type(model).__name__}")


def image_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """Every parameter and BatchNorm statistic of an image model as a leaf
    of its JAX ``params`` / ``batch_stats`` trees, in the model's
    registration order."""
    if isinstance(model, ResNet):
        return _resnet_leaves(list(model.state_dict()))
    return _zoo_leaves(model)


def jax_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """The model's parameters as the leaves of its JAX ``params`` tree, in
    ``jax.tree_util``'s flatten order (dict keys sorted at every level, so
    ``block_10`` comes before ``block_2``): the order and the layouts the
    JAX package's gradient collectives, buckets and checkpoints see."""
    names = [n for n, _ in model.named_parameters()]
    if "embed.weight" in names:
        leaves = [_lm_leaf(n) for n in names]
    else:
        leaves = [leaf for leaf in image_leaves(model) if not leaf.is_stat]
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


def _image_model(arch, names=()) -> torch.nn.Module:
    """``arch`` itself when it is a model, else that arch built on the meta
    device (names and layouts only), with its aux heads when ``names``
    (JAX top-level keys or torch names) holds them."""
    if isinstance(arch, torch.nn.Module):
        return arch
    kw = {}
    if any(str(n).split(".")[0] in ("aux1", "AuxLogits") for n in names):
        kw["aux_logits"] = True
    return models.create_model(arch, device="meta", **kw)


def image_state_dict_from_jax(arch, params: Mapping, batch_stats: Optional[Mapping],
                              device=None) -> Dict[str, torch.Tensor]:
    """An image model's JAX ``params`` and ``batch_stats`` -> the port's
    ``state_dict`` (the parameters alone when ``batch_stats`` is None, e.g.
    a momentum tree); ``arch`` is a registry name or the port's model.
    Raises ``KeyError`` naming a path the trees lack."""
    sd = {}
    for leaf in image_leaves(_image_model(arch, params)):
        if leaf.is_stat and batch_stats is None:
            continue
        tree = batch_stats if leaf.is_stat else params
        try:
            value = tree_at(tree, leaf.path)
        except KeyError:
            raise KeyError("/".join(leaf.path)) from None
        sd[leaf.name] = leaf.from_host(value, device)
    return sd


def image_variables_to_jax(arch, state_dict: Mapping) -> Dict[str, Dict]:
    """The port's image-model ``state_dict`` -> ``{"params",
    "batch_stats"}`` (``{}`` for a model without BatchNorm); the inverse of
    ``image_state_dict_from_jax``."""
    sd = _strip(state_dict)
    leaves = image_leaves(_image_model(arch, sd))
    return {"params": _tree(sd, [leaf for leaf in leaves if not leaf.is_stat]),
            "batch_stats": _tree(sd, [leaf for leaf in leaves if leaf.is_stat])}


def image_params_to_jax(arch, state_dict: Mapping) -> Dict:
    """An image model's parameters alone (a momentum ``state_dict``) -> the
    JAX ``params`` tree."""
    sd = _strip(state_dict)
    return _tree(sd, [leaf for leaf in image_leaves(_image_model(arch, sd))
                      if not leaf.is_stat])


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
