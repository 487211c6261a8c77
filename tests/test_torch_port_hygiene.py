"""The PyTorch port stands alone: no JAX import, the card by default, and a
weight carry-over that round-trips through the JAX package's bridge."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.utils.torch_import import import_lm_state_dict
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.recipes import lm_generate
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_distributed_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing JAX,
    flax or the JAX package fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import pytorch_distributed_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    assert lm_generate.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_generate.main(["--random-init", "--prompt-tokens", "1,2", "-n", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=8, d_model=8, n_heads=2, n_layers=1)


def test_weight_carry_over_round_trips():
    """JAX params -> lm_state_dict_from_jax -> the port's module ->
    its state_dict -> JAX import_lm_state_dict -> the same arrays."""
    cfg = dict(vocab_size=48, d_model=16, n_heads=2, n_layers=3)
    params = jax.jit(JaxLM(**cfg).init)(jax.random.PRNGKey(3),
                                        jnp.zeros((1, 4), jnp.int32))["params"]
    model = TransformerLM(**cfg, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    back = import_lm_state_dict(model.state_dict())["params"]
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))
