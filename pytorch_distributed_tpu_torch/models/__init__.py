"""models of the PyTorch port (mirrors pytorch_distributed_tpu/models).

``model_names()`` is the image recipes' ``-a`` surface, the JAX registry's
names; ``create_model`` builds the ResNet family, and any other arch exits
naming the ROADMAP item that will port it.
"""

from __future__ import annotations

from typing import List

import torch

from pytorch_distributed_tpu_torch.models import resnet

ZOO_ITEM = "A10 (model parallelism and the rest of the zoo)"

_RESNETS = {
    "resnet18": resnet.resnet18, "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50, "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152, "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "resnext101_32x8d": resnet.resnext101_32x8d,
}
# The JAX package's other image archs: parsed by the recipes, not ported.
_NOT_PORTED = (
    "alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
    "vgg16_bn", "vgg19_bn", "densenet121", "densenet161", "densenet169",
    "densenet201", "mobilenet_v2", "googlenet", "inception_v3", "squeezenet1_0",
    "squeezenet1_1", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "mnasnet0_5", "mnasnet0_75",
    "mnasnet1_0", "mnasnet1_3", "vit_b_16", "vit_b_32", "vit_l_16",
)


def model_names() -> List[str]:
    """Sorted image-arch names, the recipes' ``-a`` choices."""
    return sorted((*_RESNETS, *_NOT_PORTED))


def create_model(name: str, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 **kw):
    """``models.__dict__[arch]()`` for the ResNet family (``kw``: ``stem``,
    ``fused_convbn``, ``device``, ...).  Raises ``NotImplementedError``
    naming ROADMAP item A10 for the other archs of the JAX registry."""
    if name in _RESNETS:
        return _RESNETS[name](num_classes=num_classes, dtype=dtype, **kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported to the PyTorch package "
                                  f"yet: ROADMAP.md item {ZOO_ITEM}")
    raise ValueError(f"unknown arch {name!r}; choose from {model_names()}")
