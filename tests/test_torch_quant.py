"""The port's int8 weight-only serving (``models/quant.py``) against the JAX
package's, on the CPU.

- ``quantize_kernel`` and ``quantize_lm_params``: bit for bit, with an
  all-zero output channel and values at exact half steps (``np.round``
  rounds half to even); the converts-nothing error; the port's
  ``quantize_state_dict`` of the same weights gives the same int8 and
  scale tensors as the JAX tree carried over by ``lm_state_dict_from_jax``.
- ``QuantDense`` against the JAX ``QuantDense``: f32 2e-5, bf16 at the
  LM's bf16 tolerance, 6e-2 (one bf16 ulp at values of 2–4 is 1.6e-2).
- ``TransformerLM(quant="int8")``, the no-cache forward and the cached
  decode (a prefill, then one token at a time), against JAX
  ``quant="int8"``: the f32 LM tolerance, 2e-4.
- ``generate(quant="int8")``: greedy tokens identical to the JAX
  ``generate(quantize_lm_params(params), quant="int8")``, f32, from a
  quantized model and from a full-precision one quantized inside.
- ``lm_generate --resume FILE --quant int8`` on a JAX-written file prints
  the JAX recipe's tokens, f32 and bf16.

The engine at ``quant="int8"`` is held against the JAX engine in
``tests/test_torch_serving.py``, beside the other engine comparisons.
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import quant as jq
from pytorch_distributed_tpu.models.generate import generate as jax_generate
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.recipes import lm_generate as jax_lm_generate
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.models import quant
from pytorch_distributed_tpu_torch.models.generate import generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.recipes import lm_generate
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _kernel():
    """[64, 6]: random columns, an all-zero one, and one whose scale is
    exactly 1 with entries at half steps."""
    w = np.random.default_rng(0).normal(size=(64, 6)).astype(np.float32)
    w[:, 2] = 0.0
    w[:, 4] = 0.0
    w[:4, 4] = [127.0, 0.5, 1.5, -2.5]
    return w


def test_quantize_kernel_matches_jax_bitwise():
    w = _kernel()
    w_q, scale = quant.quantize_kernel(w)
    jw_q, jscale = (np.asarray(x) for x in jq.quantize_kernel(w))
    assert w_q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(w_q, jw_q)
    np.testing.assert_array_equal(scale.view(np.int32), jscale.view(np.int32))
    assert scale[2] == 1.0 and w_q[:4, 4].tolist() == [127, 0, 2, -2]


def test_quantize_lm_params_matches_jax_bitwise(params):
    got, want = quant.quantize_lm_params(params), jq.quantize_lm_params(params)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in flat_got] == [
        jax.tree_util.keystr(p) for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    for fn in (quant.quantize_lm_params, jq.quantize_lm_params):
        with pytest.raises(ValueError, match="converted no kernels"):
            fn(got)


def test_quantize_state_dict_equals_the_carried_jax_tree(params):
    got = quant.quantize_state_dict(lm_state_dict_from_jax(params))
    want = lm_state_dict_from_jax(jq.quantize_lm_params(params))
    assert got.keys() == want.keys()
    assert "blocks.0.attn.qkv.w_q" in got and "blocks.0.attn.qkv.weight" not in got
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 6e-2)])
def test_quant_dense_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    w_q, scale = quant.quantize_kernel(rng.normal(size=(64, 48)).astype(np.float32))
    bias = rng.normal(size=48).astype(np.float32)
    x = rng.normal(size=(4, 10, 64)).astype(np.float32)
    want = jq.QuantDense(48, dtype=jnp.dtype(dtype)).apply(
        {"params": {"w_q": w_q, "scale": scale, "bias": bias}}, jnp.asarray(x))
    m = quant.QuantDense(64, 48, dtype=getattr(torch, dtype))
    m.w_q.copy_(torch.from_numpy(w_q.T.copy()))
    m.scale.copy_(torch.from_numpy(scale))
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(bias))
        got = m(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _qmodel(params):
    model = TransformerLM(**CFG, device="cpu", quant="int8")
    model.load_state_dict(lm_state_dict_from_jax(jq.quantize_lm_params(params)))
    return model


def test_quant_lm_forward_and_decode_match_jax(params):
    qparams = jq.quantize_lm_params(params)
    tokens = np.random.default_rng(1).integers(0, 64, size=(2, 12)).astype(np.int32)
    want = np.asarray(JaxLM(**CFG, quant="int8").apply({"params": qparams},
                                                       jnp.asarray(tokens)))
    model = _qmodel(params)
    with torch.no_grad():
        full = model(torch.from_numpy(tokens))
        cache = model.new_cache(2, 12)
        parts = [model(torch.from_numpy(tokens[:, :6]), cache=cache)]
        parts += [model(torch.from_numpy(tokens[:, t:t + 1]), cache=cache)
                  for t in range(6, 12)]
    np.testing.assert_allclose(full.numpy(), want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), want, atol=2e-4, rtol=2e-4)


def test_quant_generate_greedy_matches_jax(params):
    prompt = np.random.default_rng(2).integers(0, 64, size=(2, 8)).astype(np.int32)
    want = np.asarray(jax_generate(jq.quantize_lm_params(params), jnp.asarray(prompt), 8,
                                   **CFG, quant="int8"))
    got = generate(_qmodel(params), torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    fp = TransformerLM(**CFG, device="cpu")
    fp.load_state_dict(lm_state_dict_from_jax(params))
    np.testing.assert_array_equal(generate(fp, torch.from_numpy(prompt), 8,
                                           quant="int8").numpy(), want)


def test_quantize_lm_keeps_the_model_shape_and_refuses_twice(params):
    fp = TransformerLM(**CFG, device="cpu")
    q = quant.quantize_lm(fp)
    assert q.quant == "int8" and q.config == {**fp.config, "quant": "int8"}
    bf = quant.quantize_lm(TransformerLM(**CFG, device="cpu", dtype=torch.bfloat16,
                                         param_dtype=torch.float32))
    assert bf.embed.weight.dtype == bf.blocks[0].fc1.bias.dtype == torch.bfloat16
    assert isinstance(q.blocks[1].fc2, quant.QuantDense)
    assert q.blocks[0].attn.qkv.w_q.dtype == torch.int8
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_lm(q)
    with pytest.raises(ValueError, match="unknown quant mode"):
        TransformerLM(**CFG, device="cpu", quant="int4")


@pytest.fixture(scope="module")
def jax_lm_file(tmp_path_factory, params):
    """``params`` in a checkpoint the JAX package wrote."""
    d = str(tmp_path_factory.mktemp("jax_lm"))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jax_ckpt.save_checkpoint(d, TrainState.create({"params": p}, sgd_init(p)), 0,
                             "transformer_lm", 0.0, is_best=False)
    return os.path.join(d, jax_ckpt.CHECKPOINT_NAME)


def _tokens_line(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return re.search(r"^tokens: (.*)$", out.getvalue(), re.M).group(1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_lm_generate_quant_matches_jax_on_a_jax_file(jax_lm_file, precision):
    """``--resume FILE --quant int8``: quantized after the load, from the
    file's f32 weights in both packages, so the greedy tokens are JAX's."""
    argv = ["--resume", jax_lm_file, "--vocab", "64", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "2", "--prompt-tokens", "5,17,3,40", "-n", "8", "--quant", "int8",
            "--precision", precision]
    assert (_tokens_line(lm_generate.main, argv + ["--device", "cpu"])
            == _tokens_line(jax_lm_generate.main, argv))
