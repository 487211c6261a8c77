"""The zoo's representatives against the JAX modules on the same weights and
images, f32, at the JAX zoo test's sizes (``tests/test_model_zoo.py``):
AlexNet at 64 px; VGG-11-BN, SqueezeNet 1.1 and ShuffleNetV2 x0.5 at 32
px here, DenseNet-121, MobileNetV2 and MNASNet 0.5 at 32 px in
``test_torch_zoo_parity_bn.py``, GoogLeNet and Inception-v3 at 96 px with
their aux heads in ``test_torch_inception.py`` (files of under a minute
each).

Weights are numpy-seeded in the JAX layout and carried across by
``utils/convert.py``; dropout is off on both sides.  The JAX side is
compiled once per arch: a training-mode forward (logits and the updated
running statistics) and an eval-mode forward and backward of a mean
cross-entropy (plus 0.3 of each aux head's).

- eval logits within 1e-4 of their largest magnitude;
- training-mode logits and the updated running statistics within 1e-3;
- eval-mode gradients: the whole gradient within 1e-2 of its norm, each
  tensor within 5e-2 of its own.

Why not 1e-4 everywhere (PERF.md, the tolerance table): at these sizes
the last stages are 1x1 planes, and a ReLU or max-pool decision within
rounding of a tie flips between the two packages.  Training-mode
BatchNorm over the batch alone then makes the networks chaotic: the port
against itself, images scaled by ``1 + 1e-7``, moves training-mode logits
by up to 4e-5 (3e-4 for Inception-v3) and a gradient by up to 0.3 of its
layer's largest entry.  In eval mode (BatchNorm affine on the running
statistics) only the flips remain: over three seeds of each arch a
tensor's gradient differed from JAX's by at most 3e-2 of its norm (MNASNet
0.5), the whole gradient by 3e-3 (VGG-11-BN, a flip in a classifier
ReLU), and by ~2e-6 where nothing flipped.
The blocks' backward is held at 1e-4 in training mode, one block at a
time, by ``test_torch_zoo_blocks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.utils.convert import (image_leaves, image_state_dict_from_jax,
                                                        tree_at)
from tests.test_torch_zoo import (  # noqa: F401  (the fixture)
    FAST_COMPILE,
    _one_torch_thread,
    images,
    jax_model,
    jax_shapes,
    no_flax_dropout,
    port_model,
    random_variables,
)

TOL = 1e-4
TRAIN_TOL = 1e-3


def jax_reference(model, variables, x, labels, capture_aux=False):
    """``(train logits, new batch_stats, eval logits, eval aux logits, eval
    grads)`` of the JAX module in one compile; the loss is the mean
    cross-entropy of the logits plus 0.3 times each aux head's."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    kw = {"capture_aux": True} if capture_aux else {}

    def ce(logits):
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(len(labels)), labels])

    def eval_loss(p):
        out = model.apply({"params": p, "batch_stats": stats}, x, train=False, **kw)
        logits, aux = out if capture_aux else (out, ())
        aux = aux if isinstance(aux, tuple) else (aux,)
        return ce(logits) + 0.3 * sum(ce(a) for a in aux), (logits, aux)

    def f(p):
        train_logits, mut = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                        mutable=["batch_stats"])
        (_, (logits, aux)), grads = jax.value_and_grad(eval_loss, has_aux=True)(p)
        return train_logits, mut.get("batch_stats", {}), logits, aux, grads

    compiled = jax.jit(f).lower(params).compile(FAST_COMPILE)
    return jax.device_get(compiled(params))


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def gradients_close(got, want, whole=1e-2, tensor=5e-2):
    """The concatenated gradient within ``whole`` of its norm, each tensor
    within ``tensor`` of its own (Frobenius)."""
    num = den = 0.0
    for name in got:
        g, w = got[name].double(), want[name].double()
        err = float((g - w).norm() / w.norm())
        assert err <= tensor, f"eval-mode gradient {name}: relative error {err} > {tensor}"
        num += float((g - w).square().sum())
        den += float(w.square().sum())
    assert (num / den) ** 0.5 <= whole, f"eval-mode gradient: relative error {(num / den) ** 0.5}"


def check_against_jax(monkeypatch, name, size, batch, train_tol=TRAIN_TOL):
    no_flax_dropout(monkeypatch)
    capture = name in ("googlenet", "inception_v3")
    jmodel = jax_model(name)
    variables = random_variables(jax_shapes(jmodel, size), 0)
    x = images(batch, size)
    labels = np.arange(batch) % 10
    train_logits, new_stats, logits, aux, grads = jax_reference(jmodel, variables, x, labels,
                                                                capture)

    model = port_model(name, variables, size).train()
    start = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), train_logits, "train-mode logits",
               train_tol)
    buffers = dict(model.named_buffers())
    for leaf in image_leaves(model):
        if leaf.is_stat:
            _close(buffers[leaf.name].numpy(), tree_at(new_stats, leaf.path),
                   f"running statistic {leaf.name}", train_tol)
            buffers[leaf.name].copy_(start[leaf.name])  # eval below: the starting statistics

    out = model.eval()(torch.from_numpy(x), **({"capture_aux": True} if capture else {}))
    got_logits, got_aux = out if capture else (out, ())
    got_aux = got_aux if isinstance(got_aux, tuple) else (got_aux,)
    ce = torch.nn.functional.cross_entropy
    lab = torch.from_numpy(labels)
    (ce(got_logits, lab) + 0.3 * sum(ce(a, lab) for a in got_aux)).backward()
    _close(got_logits.detach().numpy(), logits, "eval logits")
    assert len(got_aux) == len(aux)
    for a, w in zip(got_aux, aux):
        _close(a.detach().numpy(), w, "aux logits")
    gradients_close({n: p.grad for n, p in model.named_parameters()},
                    image_state_dict_from_jax(model, grads, None))


@pytest.mark.parametrize("name,size,batch", [
    ("alexnet", 64, 8), ("vgg11_bn", 32, 16), ("squeezenet1_1", 32, 16),
    ("shufflenet_v2_x0_5", 32, 16)])
def test_forward_backward_and_statistics_match_jax(monkeypatch, name, size, batch):
    check_against_jax(monkeypatch, name, size, batch)
