"""DenseNet-121, MobileNetV2 and MNASNet 0.5 against the JAX modules, f32,
at the JAX zoo test's 32 px: the checks and tolerances of
``test_torch_zoo_parity.py`` (one file would take over a minute).  And a
DenseNet-121 checkpoint across the packages: a file written by JAX loads
in the port exactly, the port re-saves the same bytes, JAX loads them
back; another arch's file does not fit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch import models as tm
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import image_state_dict_from_jax
from tests.test_torch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread,
    jax_model,
    jax_shapes,
    random_variables,
)
from tests.test_torch_zoo_parity import check_against_jax


@pytest.mark.parametrize("name", ["densenet121", "mobilenet_v2", "mnasnet0_5"])
def test_forward_backward_and_statistics_match_jax(monkeypatch, name):
    check_against_jax(monkeypatch, name, 32, 16)


def test_densenet_checkpoint_crosses_both_ways(tmp_path):
    name = "densenet121"
    shapes = jax_shapes(jax_model(name), 32)
    variables = random_variables(shapes, 2)
    momentum = random_variables(shapes["params"], 3)
    state = TrainState(step=jnp.asarray(9, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], momentum=momentum)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, state, 3, name, 12.5, is_best=False)
    jax_file = os.path.join(jax_dir, jax_ckpt.CHECKPOINT_NAME)
    model = tm.create_model(name, num_classes=10, device="cpu")
    opt = sgd(model.parameters())
    step, meta = ckpt.load_checkpoint(jax_file, model, opt)
    assert (step, meta["epoch"], meta["arch"], meta["best_acc1"]) == (9, 3, name, 12.5)
    want = image_state_dict_from_jax(name, variables["params"], variables["batch_stats"])
    assert all(torch.equal(t, want[n]) for n, t in model.state_dict().items())
    ckpt.save_checkpoint(port_dir, model, opt, step, 3, name, 12.5, is_best=False,
                         ft=meta["ft"])
    port_file = os.path.join(port_dir, ckpt.CHECKPOINT_NAME)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    zeros = lambda t: jax.tree_util.tree_map(np.zeros_like, t)  # noqa: E731
    back, _ = jax_ckpt.load_checkpoint(port_file, TrainState(
        step=jnp.zeros((), jnp.int32), params=zeros(variables["params"]),
        batch_stats=zeros(variables["batch_stats"]), momentum=zeros(momentum)))
    for got, ref in ((back.params, variables["params"]),
                     (back.batch_stats, variables["batch_stats"]), (back.momentum, momentum)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Another arch's file does not fit.
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load_checkpoint(jax_file, tm.create_model("densenet169", num_classes=10,
                                                       device="cpu"))
