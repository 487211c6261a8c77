"""Port's ResNet vs the JAX package's ``models/resnet.py`` on the same weights.

Weights and batch statistics cross through ``resnet_state_dict_from_jax``;
images are numpy-seeded NHWC.  Tiny models (two stages of one block, 16
filters, 16x16 images, 7 classes; the JAX tests' own) cover both block
kinds, both stems and both backward paths (fused: the JAX Pallas kernels in
interpret mode against the port's plain kernel versions).  One training-mode
forward and backward of a mean cross-entropy, f32: logits to 2e-5 (the same
f32 convs and BN in another summation order), each gradient to 5e-5 of its
largest entry (the JAX fused-vs-unfused test allows 5e-4 relative), the new
running statistics to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import resnet as jr
from pytorch_distributed_tpu.utils.torch_import import import_resnet_state_dict
from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.utils.convert import resnet_state_dict_from_jax

BLOCKS = {"bottleneck": (jr.Bottleneck, tr.Bottleneck), "basic": (jr.BasicBlock, tr.BasicBlock)}
TINY = dict(stage_sizes=[1, 1], num_classes=7, num_filters=16)


def _jax_model(block, stem="conv7", fused=False):
    return jr.ResNet(block_cls=BLOCKS[block][0], stem=stem, fused_convbn=fused, **TINY)


def _port_model(block, stem="conv7", fused=False):
    return tr.ResNet(block_cls=BLOCKS[block][1], stem=stem, fused_convbn=fused,
                     device="cpu", **TINY)


def _random_variables(jm, seed):
    """The JAX model's variable tree (traced, not compiled) filled with
    seeded random values."""
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 16, 16, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) ** 2, shapes)


def _images(n=4, size=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("block,stem,fused", [
    ("bottleneck", "conv7", False), ("bottleneck", "space_to_depth", True),
    ("basic", "conv7", True), ("basic", "space_to_depth", False)])
def test_train_forward_backward_match_jax(block, stem, fused):
    x = _images()
    labels = np.array([0, 1, 2, 3])
    jm = _jax_model(block, stem, fused)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(7), jnp.asarray(x),
                                                  train=False)

    def loss(params):
        logits, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(4), labels]), (logits, mut["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])

    tm = _port_model(block, stem, fused)
    tm.load_state_dict(resnet_state_dict_from_jax(v["params"], v["batch_stats"]))
    logits = tm.train()(torch.tensor(x))
    torch.nn.functional.cross_entropy(logits, torch.tensor(labels)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=2e-5,
                               rtol=2e-5)
    want_grads = resnet_state_dict_from_jax(jgrads, jstats)
    for name, p in tm.named_parameters():
        want = want_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=0,
                                   atol=5e-5 * float(want.abs().max()), err_msg=name)
    want_stats = resnet_state_dict_from_jax(v["params"], jstats)
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_eval_forward_matches_jax_and_fused_flag_keeps_the_state_dict():
    """Eval mode (running statistics, no kernel) matches JAX, bf16 compute
    against bf16 compute at 5e-2 (activations rounded to bf16 at other
    points; logits of size ~1); toggling the fold changes no name, shape or
    value of the state_dict."""
    x = _images(seed=1)
    jm = jr.ResNet(block_cls=jr.Bottleneck, dtype=jnp.bfloat16, **TINY)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(3), jnp.asarray(x),
                                                  train=False)
    want = jax.jit(jm.apply, static_argnames="train")(v, jnp.asarray(x), train=False)
    sd = resnet_state_dict_from_jax(v["params"], v["batch_stats"])
    for fused in (False, True):
        tm = tr.ResNet(block_cls=tr.Bottleneck, dtype=torch.bfloat16, fused_convbn=fused,
                       device="cpu", **TINY)
        tm.load_state_dict(sd)
        assert sorted(tm.state_dict()) == sorted(sd)
        with torch.no_grad():
            got = tm.eval()(torch.tensor(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2, rtol=5e-2)


def test_state_dict_round_trips_through_the_jax_bridge():
    """JAX variables -> resnet_state_dict_from_jax -> the port's module ->
    its state_dict -> the JAX import_resnet_state_dict -> the same arrays."""
    jm = jr.ResNet(block_cls=jr.BasicBlock, stage_sizes=[2, 1, 1], num_classes=5,
                   num_filters=8)
    v = _random_variables(jm, 2)
    tm = tr.ResNet(block_cls=tr.BasicBlock, stage_sizes=[2, 1, 1], num_classes=5,
                   num_filters=8, device="cpu")
    tm.load_state_dict(resnet_state_dict_from_jax(v["params"], v["batch_stats"]))
    back = import_resnet_state_dict(tm.state_dict())
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(v[col])
        got = jax.tree_util.tree_leaves_with_path(back[col])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, a), (_, b) in zip(want, got):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=jax.tree_util.keystr(path))


def test_init_follows_the_jax_model():
    """Seeded init: lecun-normal truncated at 2 std (variance 1/fan_in), the
    last BN scale of each block zero, the rest one; same param names and
    shapes as the converted JAX tree; ResNet-50 has 25.56M parameters."""
    tm = tr.ResNet(block_cls=tr.Bottleneck, device="cpu", **TINY)
    tm.init_weights(torch.Generator().manual_seed(0))
    v = _random_variables(_jax_model("bottleneck"), 0)
    want = resnet_state_dict_from_jax(v["params"], v["batch_stats"])
    assert {k: tuple(t.shape) for k, t in tm.state_dict().items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    for name, p in tm.named_parameters():
        if name.endswith("bn3.weight"):
            assert float(p.detach().abs().max()) == 0.0
        elif ".bn" in name and name.endswith("weight"):
            assert float(p.detach().min()) == float(p.detach().max()) == 1.0
    w = tm.layer1[0].conv2.weight
    bound = 2 / np.sqrt(w[0].numel()) / 0.87962566103423978
    assert float(w.detach().abs().max()) <= bound
    big = models.create_model("resnet50", device="meta")
    assert sum(p.numel() for p in big.parameters()) == 25_557_032


def test_create_model_names_and_not_ported_archs(monkeypatch):
    assert "resnet50" in models.model_names() and "vit_b_16" in models.model_names()
    with pytest.raises(NotImplementedError, match="A10"):
        models.create_model("vgg16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.create_model("resnet18")
