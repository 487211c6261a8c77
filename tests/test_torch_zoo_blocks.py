"""Each repeating block of the zoo against its JAX module, in training mode,
f32: the output, the input's gradient, every parameter's gradient and the
updated running statistics.

A whole deep network in training mode is chaotic at the JAX test sizes
(``test_torch_zoo_parity.py``): a ReLU or max-pool decision within rounding
of a tie flips between the two packages and training-mode BatchNorm over
small planes amplifies it.  One block at a moderate plane (8x8, batch 4:
BatchNorm over 256 values a channel) is well conditioned, so its backward
is held tightly here: the output and the input's gradient within 1e-4 of
their largest magnitude, each parameter's gradient within 1e-4 of the
largest entry of its layer, the running statistics within 1e-4 of their
largest.  Inputs, cotangents and weights are numpy-seeded; the weights
cross through the leaf tables of ``utils/convert.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import densenet as jd
from pytorch_distributed_tpu.models import extra as je
from pytorch_distributed_tpu.models import inception as ji
from pytorch_distributed_tpu.models import mobilenet as jmob
from pytorch_distributed_tpu_torch.models import densenet as td
from pytorch_distributed_tpu_torch.models import extra as te
from pytorch_distributed_tpu_torch.models import inception as ti
from pytorch_distributed_tpu_torch.models import mobilenet as tmob
from pytorch_distributed_tpu_torch.models.layers import Dropout
from pytorch_distributed_tpu_torch.models.resnet import Conv2d
from pytorch_distributed_tpu_torch.utils.convert import _table, tree_at
from tests.test_torch_zoo import (  # noqa: F401  (the fixture)
    FAST_COMPILE,
    _one_torch_thread,
    layer_close,
    no_flax_dropout,
    random_variables,
)

F32 = jnp.float32


def _conv(bias=False):
    return lambda *a, **k: Conv2d(*a, device="cpu", bias=bias, **k)


def _bconv(*a, **k):
    return ti.BasicConv2d(*a, device="cpu", **k)


def _flax_names(name):
    return tuple(re.sub(r"(branch\d)\.(\d)", r"\1_\2", name).split("."))


# name: (JAX module, port module, input channels, plane, JAX leaf names are
# the module's own (True) or flax's call-order numbering (False), the JAX
# call takes ``train``)
BLOCKS = {
    "inverted_residual": (lambda: jmob._InvertedResidual(16, 1, 6, F32),
                          lambda: tmob.InvertedResidual(16, 16, 1, 6, _conv(), "cpu"),
                          16, 8, False, True),
    "inverted_residual_s2": (lambda: jmob._InvertedResidual(24, 2, 6, F32),
                             lambda: tmob.InvertedResidual(16, 24, 2, 6, _conv(), "cpu"),
                             16, 8, False, True),
    "dense_layer": (lambda: jd._DenseLayer(8, F32),
                    lambda: td._DenseLayer(16, 8, _conv(), "cpu"), 16, 8, False, True),
    "fire": (lambda: je._Fire(8, 16, 16, F32), lambda: te.Fire(16, 8, 16, 16, _conv(True)),
             16, 8, False, False),
    "shuffle_unit_s1": (lambda: je._ShuffleUnit(32, 1, F32),
                        lambda: te.ShuffleUnit(32, 32, 1, _conv(), "cpu"), 32, 8, False, True),
    "shuffle_unit_s2": (lambda: je._ShuffleUnit(32, 2, F32),
                        lambda: te.ShuffleUnit(16, 32, 2, _conv(), "cpu"), 16, 8, False, True),
    "mbconv_k5": (lambda: je._MBConv(16, 1, 3, 5, F32),
                  lambda: te.MBConv(16, 16, 1, 3, 5, _conv(), "cpu"), 16, 8, False, True),
    "googlenet_inception": (lambda: ji._Inception(8, 8, 16, 4, 8, 8, F32),
                            lambda: ti.Inception(16, 8, 8, 16, 4, 8, 8, _bconv), 16, 8, True,
                            True),
    "inception_a": (lambda: ji._InceptionA(8, F32), lambda: ti.InceptionA(16, 8, _bconv),
                    16, 8, True, True),
    "inception_b": (lambda: ji._InceptionB(F32), lambda: ti.InceptionB(16, _bconv), 16, 9,
                    True, True),
    "inception_c": (lambda: ji._InceptionC(16, F32), lambda: ti.InceptionC(16, 16, _bconv),
                    16, 8, True, True),
    "inception_d": (lambda: ji._InceptionD(F32), lambda: ti.InceptionD(16, _bconv), 16, 9,
                    True, True),
    "inception_e": (lambda: ji._InceptionE(F32), lambda: ti.InceptionE(16, _bconv), 16, 4,
                    True, True),
    "inception_aux": (lambda: ji._InceptionAux(10, F32),
                      lambda: ti.InceptionAux(16, 10, _bconv, "cpu"), 16, 17, True, True),
    "googlenet_aux": (lambda: ji._GoogLeNetAux(10, F32),
                      lambda: ti.GoogLeNetAux(16, 10, _bconv, "cpu"), 16, 14, True, True),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward_backward_matches_jax(monkeypatch, name):
    jax_ctor, port_ctor, cin, plane, own_names, takes_train = BLOCKS[name]
    no_flax_dropout(monkeypatch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, plane, plane, cin), np.float32)
    jblock = jax_ctor()
    args = (True,) if takes_train else ()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), x, *args))
    variables = random_variables(shapes, 3)
    stats = variables.get("batch_stats", {})
    out_shape = jax.eval_shape(lambda v: jblock.apply(v, x, *args, mutable=["batch_stats"])[0],
                               variables).shape
    dy = rng.standard_normal(out_shape, np.float32)

    def f(params, x):
        out, mut = jblock.apply({"params": params, "batch_stats": stats}, x, *args,
                                mutable=["batch_stats"])
        return jnp.sum(out * dy), (out, mut.get("batch_stats", {}))

    compiled = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True)).lower(
        variables["params"], x).compile(FAST_COMPILE)
    (_, (out, new_stats)), (grads, dx) = jax.device_get(compiled(variables["params"], x))

    block = port_ctor().train()
    for d in block.modules():
        if isinstance(d, Dropout):
            d.p = 0.0
    leaves = _table(block, lambda n: (), _flax_names if own_names else None)
    block.load_state_dict({leaf.name: leaf.from_host(tree_at(
        stats if leaf.is_stat else variables["params"], leaf.path)) for leaf in leaves})
    xt = torch.from_numpy(x).requires_grad_()
    got = block(xt)
    (got * torch.from_numpy(dy)).sum().backward()
    for what, a, b in (("output", got.detach().numpy(), out), ("dx", xt.grad.numpy(), dx)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=what)
    named = dict(block.named_parameters())
    params = [leaf for leaf in leaves if not leaf.is_stat]
    layer_close(block, {leaf.name: named[leaf.name].grad for leaf in params},
                {leaf.name: leaf.from_host(tree_at(grads, leaf.path)) for leaf in params},
                1e-4, "gradient")
    buffers = dict(block.named_buffers())
    for leaf in leaves:
        if leaf.is_stat:
            want = np.asarray(tree_at(new_stats, leaf.path))
            np.testing.assert_allclose(buffers[leaf.name].numpy(), want, rtol=0,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=leaf.name)
