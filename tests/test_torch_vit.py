"""The port's Vision Transformer against the JAX module, at the narrow
width the JAX ViT tests register (``tests/test_vit.py``: patch 16,
d_model 32, 2 layers, 2 heads, MLP 64) and at 4 heads, on 32 px images.

Weights are numpy-seeded in the JAX layout (the per-head ``[D, H, hd]``
query/key/value and ``[H, hd, D]`` output kernels included) and carried
across by ``utils/convert.py``.  f32: logits within 1e-4 of their largest
magnitude, every gradient within 1e-4 of the largest entry of its layer
(the key bias's gradient is zero but for rounding: softmax ignores a
constant added to a row of scores); a ViT has no BatchNorm, so training
and eval mode are one function at dropout 0;
bf16 compute (f32 LayerNorm, softmax and head, as in JAX) within 6e-2.
``remat`` (``torch.utils.checkpoint``) changes no value, dropout on
included (the recomputation draws the same keyed masks); an image of
another resolution or aspect raises, as the JAX module's param shape check
does; checkpoints cross between the packages both ways.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu import models as jm
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch import models as tm
from pytorch_distributed_tpu_torch.models.layers import DropoutKey, dropout_layers, set_dropout_key
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import image_state_dict_from_jax
from tests.test_torch_zoo import (  # noqa: F401  (the fixture)
    FAST_COMPILE,
    _one_torch_thread,
    layer_close,
    random_variables,
)

NARROW = dict(patch_size=16, d_model=32, n_layers=2, n_heads=2, mlp_dim=64)


def _setup(heads=2, dtype=jnp.float32, seed=0):
    kw = dict(NARROW, n_heads=heads, num_classes=5)
    jmodel = jm.VisionTransformer(**kw, dtype=dtype)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3)), train=False))
    variables = random_variables(shapes, seed)
    x = np.random.default_rng(seed + 1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    return jmodel, variables, x, kw


def _port(kw, variables, dtype=torch.float32, **extra):
    model = tm.VisionTransformer(**kw, dtype=dtype, image_size=32, device="cpu", **extra)
    model.load_state_dict(image_state_dict_from_jax(model, variables["params"], None))
    return model


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("heads", [2, 4])
def test_forward_and_gradients_match_jax(heads):
    jmodel, variables, x, kw = _setup(heads)
    labels = np.array([0, 1, 2, 3])

    def loss(p):
        logits = jmodel.apply({"params": p}, x, train=True)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(4), labels]), logits

    f = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(variables["params"])
    (_, want), grads = jax.device_get(f.compile(FAST_COMPILE)(variables["params"]))
    model = _port(kw, variables).train()
    logits = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    _close(logits.detach().numpy(), want, 1e-4, "logits")
    layer_close(model, {n: p.grad for n, p in model.named_parameters()},
                image_state_dict_from_jax(model, grads, None), 1e-4, "gradient")


def test_bf16_forward_matches_jax():
    jmodel, variables, x, kw = _setup(dtype=jnp.bfloat16)
    want = jax.jit(lambda v: jmodel.apply(v, x, train=False))(variables)
    model = _port(kw, variables, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 6e-2, "bf16 logits")


def test_remat_changes_no_value():
    _, variables, x, kw = _setup()
    out = []
    for remat in (False, True):
        model = _port(kw, variables, remat=remat).train()
        logits = model(torch.from_numpy(x))
        logits.square().sum().backward()
        out.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (a, ga), (b, gb) = out
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=1e-5, atol=1e-6)


def test_remat_redraws_the_same_dropout_masks():
    """With dropout on (attention included), the recomputed blocks draw the
    masks of the first pass: the masks are keyed, not drawn from a
    generator's state."""
    _, variables, x, kw = _setup()
    out = []
    for remat in (False, True):
        model = _port(dict(kw, dropout=0.3), variables, remat=remat).train()
        set_dropout_key(dropout_layers(model), DropoutKey(seed=5, step=2))
        logits = model(torch.from_numpy(x))
        logits.square().sum().backward()
        out.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (a, ga), (b, gb) = out
    with torch.no_grad():
        assert not torch.equal(a, model.eval()(torch.from_numpy(x)))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=1e-5, atol=1e-6)


def test_wrong_resolution_fails_loudly():
    """A 2x2 grid of 16 px patches: 64x64 (4x4 grid) and 16x64 (the same
    token count, another aspect) both raise, as in JAX."""
    tm.register("vit_tiny_test", functools.partial(tm.VisionTransformer, **NARROW))
    model = tm.create_model("vit_tiny_test", num_classes=7, device="cpu", image_size=32)
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 7)
    for shape in ((1, 64, 64, 3), (1, 16, 64, 3)):
        with pytest.raises(ValueError, match="[Ss]hape"):
            model(torch.zeros(shape))
    with pytest.raises(ValueError, match="not divisible by patch size"):
        model(torch.zeros(1, 40, 40, 3))


def test_checkpoints_cross_both_ways(tmp_path):
    """JAX writes, the port loads exactly and re-saves the same bytes, JAX
    loads the port's file back (no batch_stats: the ViT has none)."""
    _, variables, _, kw = _setup()
    params = variables["params"]
    momentum = random_variables(jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params), 5)
    state = TrainState(step=jnp.asarray(7, jnp.int32), params=params, batch_stats={},
                       momentum=momentum)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, state, 1, "vit_tiny_test", 3.5, is_best=False)
    jax_file = os.path.join(jax_dir, jax_ckpt.CHECKPOINT_NAME)
    model = tm.VisionTransformer(**kw, image_size=32, device="cpu")
    opt = sgd(model.parameters())
    step, meta = ckpt.load_checkpoint(jax_file, model, opt)
    assert step == 7 and meta["arch"] == "vit_tiny_test"
    ckpt.save_checkpoint(port_dir, model, opt, step, meta["epoch"], meta["arch"],
                         meta["best_acc1"], is_best=False, ft=meta["ft"])
    port_file = os.path.join(port_dir, ckpt.CHECKPOINT_NAME)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    template = TrainState(step=jnp.zeros((), jnp.int32),
                          params=jax.tree_util.tree_map(np.zeros_like, params), batch_stats={},
                          momentum=jax.tree_util.tree_map(np.zeros_like, params))
    back, _ = jax_ckpt.load_checkpoint(port_file, template)
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(back.momentum),
                    jax.tree_util.tree_leaves(momentum)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
