"""models of the PyTorch port (mirrors pytorch_distributed_tpu/models).

The image registry is the JAX package's: ``model_names()`` is the image
recipes' ``-a`` surface (the reference's torchvision namespace plus the ViT
family), ``create_model(name, ...)`` builds any of them and ``register``
adds one (the JAX tests register narrow ViTs through it).  ``stem`` and
``fused_convbn`` are ResNet-only keywords; ``image_size`` reaches only the
constructors that take it (the ViT, whose position grid it fixes).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List

import torch

from pytorch_distributed_tpu_torch.models import densenet, extra, inception, mobilenet, resnet
from pytorch_distributed_tpu_torch.models import simple, vit
from pytorch_distributed_tpu_torch.models.resnet import ResNet  # noqa: F401
from pytorch_distributed_tpu_torch.models.vit import VisionTransformer  # noqa: F401

_REGISTRY: Dict[str, Callable] = {
    "alexnet": simple.alexnet,
    "vgg11": simple.vgg11, "vgg13": simple.vgg13, "vgg16": simple.vgg16,
    "vgg19": simple.vgg19, "vgg11_bn": simple.vgg11_bn, "vgg13_bn": simple.vgg13_bn,
    "vgg16_bn": simple.vgg16_bn, "vgg19_bn": simple.vgg19_bn,
    "densenet121": densenet.densenet121, "densenet161": densenet.densenet161,
    "densenet169": densenet.densenet169, "densenet201": densenet.densenet201,
    "mobilenet_v2": mobilenet.mobilenet_v2,
    "googlenet": inception.googlenet, "inception_v3": inception.inception_v3,
    "resnet18": resnet.resnet18, "resnet34": resnet.resnet34, "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101, "resnet152": resnet.resnet152,
    "wide_resnet50_2": resnet.wide_resnet50_2, "wide_resnet101_2": resnet.wide_resnet101_2,
    "resnext50_32x4d": resnet.resnext50_32x4d, "resnext101_32x8d": resnet.resnext101_32x8d,
    "squeezenet1_0": extra.squeezenet1_0, "squeezenet1_1": extra.squeezenet1_1,
    "shufflenet_v2_x0_5": extra.shufflenet_v2_x0_5,
    "shufflenet_v2_x1_0": extra.shufflenet_v2_x1_0,
    "shufflenet_v2_x1_5": extra.shufflenet_v2_x1_5,
    "shufflenet_v2_x2_0": extra.shufflenet_v2_x2_0,
    "mnasnet0_5": extra.mnasnet0_5, "mnasnet0_75": extra.mnasnet0_75,
    "mnasnet1_0": extra.mnasnet1_0, "mnasnet1_3": extra.mnasnet1_3,
    # Beyond the torchvision namespace, as in the JAX registry.
    "vit_b_16": vit.vit_b_16, "vit_b_32": vit.vit_b_32, "vit_l_16": vit.vit_l_16,
}
# Families with no BatchNorm at all: --sync-bn has nothing to synchronise
# (the JAX modules without a ``bn_axis_name`` field).
_NO_BATCHNORM = (simple.AlexNet, extra.SqueezeNet, vit.VisionTransformer)


def register(name: str, ctor: Callable) -> None:
    """Add an image model to the registry (``ctor(num_classes=, dtype=,
    device=, ...)``)."""
    _REGISTRY[name] = ctor


def model_names() -> List[str]:
    """Sorted image-arch names, the recipes' ``-a`` choices."""
    return sorted(_REGISTRY)


def _family(name: str):
    ctor = _REGISTRY[name]
    return getattr(ctor, "func", ctor)


def is_resnet(name: str) -> bool:
    """Whether ``name`` builds a ``ResNet`` (the only family with ``stem``
    and ``fused_convbn``)."""
    return name in _REGISTRY and _family(name) is ResNet


def check_sync_bn(name: str) -> None:
    """The JAX trainer's ``--sync-bn`` refusals (explicit step): an arch
    without BatchNorm, and a plain VGG, raise ``ValueError`` with its
    messages."""
    family = _family(name)
    if isinstance(family, type) and issubclass(family, _NO_BATCHNORM):
        raise ValueError(f"--sync-bn: arch {name!r} has no BatchNorm layers to synchronize "
                         "(no bn_axis_name knob)")
    if family is simple.VGG and not _REGISTRY[name].keywords.get("batch_norm", False):
        raise ValueError(simple.PLAIN_VGG_SYNC_BN)


def create_model(name: str, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 image_size=None, **kw):
    """``models.__dict__[arch]()``: any arch of ``model_names()`` (``kw``:
    ``device``, the ResNets' ``stem`` and ``fused_convbn``, GoogLeNet's and
    Inception-v3's ``aux_logits``, ...).  ``image_size`` goes to the
    constructors that take it."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown arch {name!r}; choose from {model_names()}")
    ctor = _REGISTRY[name]
    if image_size is not None and "image_size" in inspect.signature(ctor).parameters:
        kw["image_size"] = image_size
    return ctor(num_classes=num_classes, dtype=dtype, **kw)
