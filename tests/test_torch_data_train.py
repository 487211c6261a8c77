"""``tpu_native --data`` on the CPU against the JAX ``Trainer`` on the same
ImageFolder tree, one train step per ``--wire`` mode.

ResNet-18 at 32x32, batch 8, f32, seed 0, two classes (``num_classes`` from
the tree), JPEG and PNG files of 20-90 px.  The JAX trainer's weights reach
the port through ``utils/convert.py``.  Per mode: the first train batch as
the step sees it (after each side's feeder) within 1e-6 (the f32 and u8host
batches are equal; u8 and native are normalized by each feeder); the loss
to rtol 1e-4; the gradients (the port's ``.grad`` against the gradient the
JAX SGD update implies, ``(p0 - p1) / lr - wd * p0``, whose rounding is
~1e-7), the updated weights and the running statistics to atol 1e-4,
rtol 1e-3 (the gradients' atol times the model's largest gradient entry:
the blocks' last BN scales start at zero, so some gradients are exactly
zero on both sides): the tolerances of
``tests/test_torch_image_train.py``.  Every JAX trainer is built with the
same step arguments, so the first one's compiled step serves all four.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.train.config import Config as JaxConfig
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu_torch.recipes import tpu_native
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils.convert import resnet_state_dict_from_jax
from tests.test_torch_zoo import jitted_flax_init  # noqa: F401  (fixture)

LR, WD = 0.1, 1e-4
WIRES = ("f32", "u8host", "u8", "native")
# The JAX trainers' weights are copied into the port, so their init may be
# compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split, n in (("train", 5), ("val", 3)):
        for c in ("cat", "dog"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(20, 90, 2))
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                fmt, ext = ("PNG", "png") if i % 3 == 2 else ("JPEG", "JPEG")
                Image.fromarray(arr).save(d / f"{i}.{ext}", format=fmt)
    return root


@pytest.fixture(scope="module")
def jax_runs(tree, tmp_path_factory):
    """Per wire mode: the JAX trainer's first train batch (after its
    feeder), its weights before the step, and the step's metrics and new
    state."""
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    out, step = {}, None
    for wire in WIRES:
        cfg = JaxConfig(arch="resnet18", batch_size=8, epochs=1, seed=0, data=str(tree),
                        image_size=32, wire=wire, workers=2, precision="fp32",
                        checkpoint_dir=str(tmp_path_factory.mktemp("jck")))
        jt = JaxTrainer(cfg, mesh=mesh)
        step = step or jt.train_step
        jt.train_loader.set_epoch(0)
        with contextlib.closing(jt.feeder(jt.train_loader.iter_batches(0))) as it:
            batch = next(it)
        before = jax.device_get((jt.state.params, jt.state.batch_stats))
        state, metrics = step(jt.state, batch, jnp.float32(LR))
        out[wire] = (jax.device_get(batch), before, jax.device_get(metrics),
                     jax.device_get((state.params, state.batch_stats)))
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_one_step_per_wire_mode_matches_jax(tree, jax_runs, tmp_path, wire):
    jbatch, (p0, s0), jmetrics, (p1, s1) = jax_runs[wire]
    t = Trainer(parse_config(["--data", str(tree), "-a", "resnet18", "--image-size", "32",
                              "-b", "8", "--wire", wire, "--precision", "fp32", "--seed", "0",
                              "-j", "2", "--device", "cpu", "--epochs", "1",
                              "--checkpoint-dir", str(tmp_path)]))
    assert t.cfg.num_classes == 2 and len(t.train_loader) == 1
    t.model.load_state_dict(resnet_state_dict_from_jax(p0, s0))
    t.train_loader.set_epoch(0)
    with contextlib.closing(t.feeder(t.train_loader.iter_batches(0))) as it:
        batch = next(it)
    for key in ("images", "labels", "weights"):
        np.testing.assert_allclose(batch[key].numpy(), np.asarray(jbatch[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    assert t.train_epoch(0, stop_after=1) == 1
    np.testing.assert_allclose(float(t.losses[0]), float(jmetrics["loss"]), rtol=1e-4)
    want = resnet_state_dict_from_jax(p1, s1)
    for name, v in t.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    jgrads = {n: (before[n] - want[n]) / LR - WD * before[n] for n in before}
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in t.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_recipe_runs_an_epoch_on_the_tree(tree, tmp_path, capsys):
    """Train and validate through ``tpu_native.main`` on the CPU, with
    fused conv-BN, as a user would."""
    best = tpu_native.main(["--data", str(tree), "-a", "resnet18", "--fused-convbn",
                            "--image-size", "32", "-b", "8", "--wire", "u8", "--device", "cpu",
                            "--epochs", "1", "-p", "1", "--checkpoint-dir", str(tmp_path),
                            "--epoch-csv", str(tmp_path / "e.csv")])
    assert 0.0 <= best <= 100.0
    assert " * Acc@1 " in capsys.readouterr().out


def test_native_without_libjpeg_raises_the_jax_message(tree, tmp_path, monkeypatch):
    from pytorch_distributed_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "jpeg_native_available", lambda: False)
    with pytest.raises(RuntimeError, match="--wire native needs the C\\+\\+ data plane built "
                       "against libjpeg"):
        Trainer(parse_config(["--data", str(tree), "--wire", "native", "--device", "cpu",
                              "--checkpoint-dir", str(tmp_path)]))
