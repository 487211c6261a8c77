"""GoogLeNet and Inception-v3 against the JAX modules, f32, at the JAX zoo
test's 96 px with their aux heads: the checks of
``test_torch_zoo_parity.py``, the aux logits (``capture_aux``) and their
heads' gradients included; the aux heads' parameters exist only with
``aux_logits`` and an ordinary forward returns the main logits alone.

Inception-v3's training-mode forward is held to 1e-2, not 1e-3 (PERF.md,
the tolerance table): its last planes are 1x1 and 96 px feed BatchNorm 8
values a channel there, so the port against itself, images scaled by
``1 + 1e-7``, moves its training-mode logits by up to 3e-4 (against JAX:
1.8e-3)."""

import numpy as np
import pytest
import torch

from tests.test_torch_zoo import _one_torch_thread, images, port_model  # noqa: F401
from tests.test_torch_zoo_parity import check_against_jax


@pytest.mark.parametrize("name,train_tol", [("googlenet", 1e-3), ("inception_v3", 1e-2)])
def test_forward_backward_aux_and_statistics_match_jax(monkeypatch, name, train_tol):
    check_against_jax(monkeypatch, name, 96, 8, train_tol=train_tol)


@pytest.mark.parametrize("name,aux", [("googlenet", ("aux1", "aux2")),
                                      ("inception_v3", ("AuxLogits",))])
def test_aux_heads_only_with_aux_logits_and_capture(name, aux):
    from pytorch_distributed_tpu_torch import models

    plain = models.create_model(name, num_classes=5, device="cpu")
    assert not any(n.split(".")[0] in aux for n, _ in plain.named_parameters())
    model = models.create_model(name, num_classes=5, device="cpu", aux_logits=True)
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    assert {n.split(".")[0] for n, _ in model.named_parameters()} >= set(aux)
    x = torch.from_numpy(images(2, 96))
    with torch.no_grad():
        logits = model(x)
        main, heads = model(x, capture_aux=True)
    assert logits.shape == (2, 5) and torch.equal(logits, main)
    heads = heads if isinstance(heads, tuple) else (heads,)
    assert len(heads) == len(aux) and all(h.shape == (2, 5) for h in heads)
    assert all(np.isfinite(h.numpy()).all() for h in heads)
