"""The port's speculative decoding (``models/speculative.py``) against the JAX
package's, on the CPU, f32.

- ``_accept`` and ``_resample``: the same answers and the same numpy rng
  state afterwards, on the same ``p``, ``q`` and ``default_rng`` seed;
  ``_dist`` to 1e-6 (f32 softmax on both sides) and summing to 1 in
  float64.
- ``speculative_generate`` greedy: identical to JAX's tokens and stats and
  to the target's own greedy stream (gamma 1, 3, 4); the target as its own
  draft accepts every proposal; an int8 target equals its own int8
  greedy stream.
- Sampled (temperature 0.8, top-k 8): identical tokens and stats to JAX's
  for two seeds.  The draws come from the same numpy generator in the same
  order, and the two sides' distributions differ by ~1e-7, far below the
  spacing of the draws.
- ``lm_generate --spec-draft``: a JAX-written draft file gives JAX's tokens
  and stats line; ``random`` runs; ``--tp`` gets the JAX refusal.

The engine's speculative round is held against the JAX engine in
``tests/test_torch_serving.py``.
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

from pytorch_distributed_tpu.models import speculative as js
from pytorch_distributed_tpu.models.generate import greedy_generate as jax_greedy
from pytorch_distributed_tpu.models.quant import quantize_lm_params
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.recipes import lm_generate as jax_lm_generate
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.models import speculative as ps
from pytorch_distributed_tpu_torch.recipes import lm_generate
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax
from tests.test_torch_zoo import jitted_flax_init  # noqa: F401  (fixture)

TARGET = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
DRAFT = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1)
# The JAX recipes' own init is replaced by the weights under test, so it may
# be compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(cfg, seed):
    p = jax.jit(JaxLM(**cfg).init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _both(tp, dp, prompt, n_new, dcfg=DRAFT, **kw):
    """(JAX's (tokens, stats), the port's) for the same weights."""
    want, wstats = js.speculative_generate(tp, dp, jnp.asarray(prompt), n_new,
                                           target_cfg=TARGET, draft_cfg=dcfg, **kw)
    got, gstats = ps.speculative_generate(
        lm_state_dict_from_jax(tp), lm_state_dict_from_jax(dp), torch.from_numpy(prompt),
        n_new, target_cfg=TARGET, draft_cfg=dcfg, device="cpu", **kw)
    return (np.asarray(want), wstats), (got.numpy(), gstats)


def test_accept_and_resample_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(50):
        p, q = rng.dirichlet(np.ones(16)), rng.dirichlet(np.ones(16))
        if trial % 10 == 0:
            q = p.copy()                 # the degenerate residual
        x = int(rng.integers(0, 16))
        for greedy in (False, True):
            a, b = np.random.default_rng(trial), np.random.default_rng(trial)
            assert ps._accept(p, q, x, a, greedy) == js._accept(p, q, x, b, greedy)
            assert ps._resample(p, q, a, greedy) == js._resample(p, q, b, greedy)
            assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.0, 0, 0.0), (1.1, 0, 0.0),
                                                      (0.8, 50, 0.9), (0.8, 0, 0.9)])
def test_dist_matches_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(3).normal(0, 4, size=32_768).astype(np.float32)
    got = ps._dist(torch.from_numpy(logits), temperature, top_k, top_p)
    want = js._dist(logits, temperature, top_k, top_p)
    assert got.dtype == np.float64 and abs(got.sum() - 1.0) <= 1e-12
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0) == (want > 0)).all()


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_equals_jax_and_the_target_stream(gamma):
    tp, dp = _init(TARGET, 0), _init(DRAFT, 7)
    prompt = np.random.default_rng(0).integers(0, 64, size=(1, 6)).astype(np.int32)
    (want, wstats), (got, gstats) = _both(tp, dp, prompt, 12, gamma=gamma)
    np.testing.assert_array_equal(got, want)
    assert gstats == wstats
    np.testing.assert_array_equal(
        got, np.asarray(jax_greedy(tp, jnp.asarray(prompt), 12, **TARGET)))


def test_self_draft_accepts_everything():
    tp = _init(TARGET, 1)
    prompt = np.zeros((1, 4), np.int32)
    (want, wstats), (got, gstats) = _both(tp, tp, prompt, 13, gamma=4, dcfg=TARGET)
    np.testing.assert_array_equal(got, want)
    assert gstats == wstats and gstats["tokens_per_target_pass"] > 2.0


@pytest.mark.parametrize("seed", [5, 11])
def test_sampled_tokens_and_stats_match_jax(seed):
    tp, dp = _init(TARGET, 2), _init(DRAFT, 3)
    prompt = np.zeros((1, 4), np.int32)
    (want, wstats), (got, gstats) = _both(tp, dp, prompt, 12, gamma=3, temperature=0.8,
                                          top_k=8, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert gstats == wstats


def test_int8_target_equals_its_own_greedy_stream():
    tp, dp = _init(TARGET, 4), _init(DRAFT, 5)
    prompt = np.zeros((1, 5), np.int32)
    want = np.asarray(jax_greedy(quantize_lm_params(tp), jnp.asarray(prompt), 9, **TARGET,
                                 quant="int8"))
    got, stats = ps.speculative_generate(
        lm_state_dict_from_jax(tp), lm_state_dict_from_jax(dp), torch.from_numpy(prompt), 9,
        target_cfg=TARGET, draft_cfg=DRAFT, gamma=3, quant="int8", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["tokens"] == 9


def test_batch_and_vocab_checks():
    tp, dp = _init(TARGET, 0), _init(DRAFT, 7)
    t, d = lm_state_dict_from_jax(tp), lm_state_dict_from_jax(dp)
    with pytest.raises(ValueError, match="batch-1"):
        ps.speculative_generate(t, d, torch.zeros((2, 3), dtype=torch.long), 4,
                                target_cfg=TARGET, draft_cfg=DRAFT, device="cpu")
    with pytest.raises(ValueError, match="share a vocabulary"):
        ps.speculative_generate(t, lm_state_dict_from_jax(_init(dict(DRAFT, vocab_size=32), 1)),
                                torch.zeros((1, 3), dtype=torch.long), 4, target_cfg=TARGET,
                                draft_cfg=dict(DRAFT, vocab_size=32), device="cpu")


def _save_jax(tmp_path_factory, params, name):
    d = str(tmp_path_factory.mktemp(name))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jax_ckpt.save_checkpoint(d, TrainState.create({"params": p}, sgd_init(p)), 0,
                             "transformer_lm", 0.0, is_best=False)
    return os.path.join(d, jax_ckpt.CHECKPOINT_NAME)


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    text = out.getvalue()
    return (re.search(r"^tokens: (.*)$", text, re.M).group(1),
            re.search(r"^speculative: (.*)$", text, re.M).group(1))


def test_lm_generate_spec_draft_file_matches_jax(tmp_path_factory):
    """Target and draft from JAX-written files: JAX's tokens and stats."""
    target = _save_jax(tmp_path_factory, _init(TARGET, 0), "target")
    draft = _save_jax(tmp_path_factory, _init(DRAFT, 7), "draft")
    argv = ["--resume", target, "--vocab", "64", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "2", "--prompt-tokens", "5,17,3,40,9,2", "-n", "12",
            "--spec-draft", draft, "--spec-d-model", "16", "--spec-n-heads", "2",
            "--spec-n-layers", "1", "--spec-gamma", "3"]   # the shapes of the gamma-3 case
    assert _run(lm_generate.main, argv + ["--device", "cpu"]) == _run(jax_lm_generate.main,
                                                                       argv)


def test_lm_generate_spec_draft_random_and_tp_refusal(capsys):
    argv = ["--random-init", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "2", "--prompt-tokens", "1,2,3", "-n", "6", "--device", "cpu"]
    assert lm_generate.main(argv + ["--spec-draft", "random"]) == 0
    out = capsys.readouterr().out
    assert "speculative: " in out and "tok/pass" in out
    with pytest.raises(SystemExit, match="does not compose with --tp"):
        lm_generate.main(argv + ["--spec-draft", "random", "--tp", "2"])
