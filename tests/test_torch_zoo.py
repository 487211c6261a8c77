"""The port's image zoo against the JAX package's registry: names, shapes,
the registry surface and the trainer's refusals.

- Every one of the 29 archs beyond the ResNets: the port's parameter and
  BatchNorm-statistic leaves (``utils/convert.py::image_leaves``: each
  tensor's JAX path, viewed in the JAX layout) equal, path for path and
  shape for shape, the trees of ``jax.eval_shape(model.init, ...)`` (the
  aux heads of GoogLeNet and Inception-v3 included); a model with no
  BatchNorm has no ``batch_stats``.
- ``create_model`` builds every name of ``model_names()`` (38) on the CPU,
  ``register`` adds a name, ``is_resnet`` tells the ResNets apart.
- The JAX trainer's refusals, word for word: ``--stem`` /
  ``--fused-convbn`` on a non-ResNet; ``--sync-bn`` on the explicit step
  for an arch without BatchNorm and for a plain VGG.

The helpers here (numpy-seeded variables in the JAX layout, a JAX
reference compiled once per arch) serve the other zoo test files.
"""

import functools
import socket

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu import models as jm
from pytorch_distributed_tpu_torch import models as tm
from pytorch_distributed_tpu_torch.models.layers import Dropout
from pytorch_distributed_tpu_torch.ops.fused_bn import FusedBatchNormAct
from pytorch_distributed_tpu_torch.recipes import horovod_distributed, tpu_native
from pytorch_distributed_tpu_torch.utils.convert import image_leaves, image_state_dict_from_jax

ZOO = [n for n in tm.model_names() if not tm.is_resnet(n)]
# The JAX zoo test's input sizes: AlexNet's 11x11/s4 stem needs 64 px, the
# Inceptions 96.
SIZES = {"alexnet": 64, "googlenet": 96, "inception_v3": 96}
AUX = ("googlenet", "inception_v3")
# XLA's CPU backend without its slow passes: these references compile in
# about half the time, and f32 arithmetic is the same operations.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def jitted_flax_init():
    """flax ``Module.init`` compiled as one program (``FAST_COMPILE``)
    rather than run op by op, for the module that asks for it.  A JAX
    trainer initializes its weights with ``model.init`` outside ``jit``:
    one XLA compile per initializer and shape, ~13 s for ResNet-18 on one
    core against ~2 s as one program.  The values can differ from the eager
    ones in their last bits: use it only where the test copies the JAX
    trainer's weights into the port (or replaces them), never where it
    holds them against a fixed number."""
    orig, programs = fnn.Module.init, {}

    def init(self, rngs, *args, **kwargs):
        leaves, tree = jax.tree_util.tree_flatten((rngs, args))
        if any(isinstance(x, jax.core.Tracer) for x in leaves):
            return orig(self, rngs, *args, **kwargs)  # already inside jit or eval_shape
        key = (type(self), repr(self), tuple(sorted(kwargs.items())), tree,
               tuple((getattr(x, "shape", ()), str(getattr(x, "dtype", type(x)))) for x in leaves))
        if key not in programs:  # a module's repr lists its fields
            programs[key] = jax.jit(functools.partial(orig, self, **kwargs)).lower(
                rngs, *args).compile(FAST_COMPILE)
        return programs[key](rngs, *args)

    fnn.Module.init = init
    yield
    fnn.Module.init = orig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel suite, intra-op threads contend for the cores, so
    this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(name, dtype=jnp.float32, **kw):
    if name in AUX:
        kw.setdefault("aux_logits", True)
    return jm.create_model(name, num_classes=10, dtype=dtype, **kw)


def jax_shapes(model, size):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, size, size, 3)), train=False))


def random_variables(shapes, seed):
    """Numpy-seeded values for a JAX variable tree: lecun-scaled kernels
    (fan-in: every axis but the last; the ViT's query/key/value kernels
    ``[D, H, hd]``: D), BatchNorm scales near one, variances above one,
    everything else small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = path[-1].key
        if key == "kernel":
            fan = (s.shape[0] if path[-2].key in ("query", "key", "value")
                   else int(np.prod(s.shape[:-1])))
            return rng.standard_normal(s.shape, np.float32) / np.float32(np.sqrt(fan))
        if key == "scale":
            return 1 + np.float32(0.1) * rng.standard_normal(s.shape, np.float32)
        if key == "var":
            return 1 + np.float32(0.2) * np.abs(rng.standard_normal(s.shape, np.float32))
        return np.float32(0.1) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def images(batch, size, seed=1):
    return np.random.default_rng(seed).normal(size=(batch, size, size, 3)).astype(np.float32)


def no_flax_dropout(monkeypatch):
    """Dropout off in the JAX modules (the port's is set to p=0 by
    ``port_model``): the masks come from different generators."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def port_model(name, variables, size, dtype=torch.float32, **kw):
    if name in AUX:
        kw.setdefault("aux_logits", True)
    model = tm.create_model(name, num_classes=10, dtype=dtype, device="cpu", image_size=size,
                            **kw)
    model.load_state_dict(image_state_dict_from_jax(model, variables["params"],
                                                    variables.get("batch_stats", {})))
    for d in model.modules():
        if isinstance(d, Dropout):
            d.p = 0.0
    return model


def layer_close(model, got, want, frac, what):
    """Each tensor of ``got`` (torch name -> tensor) within ``frac`` of the
    largest entry of its layer's tensors in ``want``: a conv bias before a
    training-mode BatchNorm, or a BatchNorm bias before another, has a
    gradient that is zero but for rounding, so its own largest entry is no
    scale."""
    for name in got:
        layer = name.rsplit(".", 1)[0] if "." in name else name
        scale = max(float(w.abs().max()) for k, w in want.items()
                    if (k.rsplit(".", 1)[0] if "." in k else k) == layer)
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0,
                                   atol=frac * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", ZOO)
def test_leaves_match_the_jax_trees(name):
    size = SIZES.get(name, 32)
    shapes = jax_shapes(jax_model(name), size)
    model = tm.create_model(name, num_classes=10, device="meta", image_size=size,
                            **({"aux_logits": True} if name in AUX else {}))
    sd = model.state_dict()
    leaves = image_leaves(model)
    assert sorted(leaf.name for leaf in leaves) == sorted(sd)
    for col, stat in (("params", False), ("batch_stats", True)):
        want = {tuple(k.key for k in p): tuple(v.shape)
                for p, v in jax.tree_util.tree_leaves_with_path(shapes.get(col, {}))}
        got = {leaf.path: tuple(leaf.to_jax(sd[leaf.name]).shape)
               for leaf in leaves if leaf.is_stat == stat}
        assert got == want, col
    assert ("batch_stats" in shapes) == any(isinstance(m, FusedBatchNormAct)
                                            for m in model.modules())


@pytest.mark.parametrize("name", tm.model_names())
def test_create_model_builds_every_arch_on_the_cpu(name):
    model = tm.create_model(name, num_classes=10, device="cpu")
    p = next(model.parameters())
    assert p.device.type == "cpu" and p.dtype == torch.float32


def test_registry_surface():
    assert len(tm.model_names()) == 38 and set(tm.model_names()) == set(jm.model_names())
    assert len(ZOO) == 29 and tm.is_resnet("resnet50") and not tm.is_resnet("vgg16")
    tm.register("vit_tiny_port_test", functools.partial(
        tm.VisionTransformer, patch_size=16, d_model=32, n_layers=1, n_heads=2, mlp_dim=64))
    model = tm.create_model("vit_tiny_port_test", num_classes=3, device="cpu", image_size=32)
    assert tuple(model.pos_embedding.shape) == (1, 2, 2, 32)
    assert "vit_tiny_port_test" in tm.model_names()
    with pytest.raises(ValueError, match="unknown arch"):
        tm.create_model("vgg17")


ARGS = ["--device", "cpu", "--synthetic", "--image-size", "32", "-b", "4",
        "--synthetic-length", "8", "--epochs", "1", "-p", "1", "--num-classes", "10"]


@pytest.mark.parametrize("flags", [["--fused-convbn"], ["--stem", "space_to_depth"]])
def test_resnet_knobs_are_refused_on_other_archs(tmp_path, flags):
    with pytest.raises(ValueError, match="^--stem/--fused-convbn only apply to the ResNet "
                       "family; arch 'mobilenet_v2' has no such variant$"):
        tpu_native.main(ARGS + ["-a", "mobilenet_v2", "--checkpoint-dir", str(tmp_path)]
                        + flags)


@pytest.mark.parametrize("arch,message", [
    ("alexnet", "^--sync-bn: arch 'alexnet' has no BatchNorm layers to synchronize "
                "\\(no bn_axis_name knob\\)$"),
    ("vit_b_32", "^--sync-bn: arch 'vit_b_32' has no BatchNorm layers to synchronize "
                 "\\(no bn_axis_name knob\\)$"),
    ("vgg11", "^bn_axis_name \\(--sync-bn\\) on a plain VGG: this variant has no BatchNorm "
              "layers to synchronize — use the \\*_bn arch or drop the flag$")])
def test_sync_bn_is_refused_without_batchnorm(tmp_path, monkeypatch, arch, message):
    """The explicit step (``horovod_distributed``, a gloo world of one)
    refuses ``--sync-bn`` where JAX does; the group is taken down again."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES="1",
                     PTD_TPU_PROCESS_ID="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=message):
        horovod_distributed.main(ARGS + ["-a", arch, "--sync-bn", "--checkpoint-dir",
                                         str(tmp_path)])
    assert not torch.distributed.is_initialized()
