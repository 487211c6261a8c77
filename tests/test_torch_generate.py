"""Port's generate / filter_logits vs the JAX package's, same weights.

Greedy tokens must be identical (f32; the logits agree to ~1e-6 and no
argmax here is that close to a tie).  Sampled tokens are not compared
across frameworks: ``jax.random`` and ``torch.Generator`` draw different
numbers from one seed, so sampling is checked for determinism and for its
greedy limits instead.  The bf16 decode run is held at 6e-2, the bf16
tolerance of test_torch_transformer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.generate import filter_logits as jax_filter
from pytorch_distributed_tpu.models.generate import greedy_generate as jax_greedy
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu_torch.models.generate import (
    filter_logits,
    generate,
    greedy_generate,
)
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _port(params, dtype=torch.float32):
    model = TransformerLM(**CFG, dtype=dtype, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    return model


def _prompt(B=2, P=16, seed=1):
    return np.random.default_rng(seed).integers(0, 64, size=(B, P)).astype(np.int32)


@pytest.mark.parametrize("flash_prefill", [False, True])
def test_greedy_tokens_match_jax(params, flash_prefill):
    prompt = _prompt()
    want = jax_greedy(params, jnp.asarray(prompt), 6, **CFG,
                      flash_prefill=flash_prefill)
    got = greedy_generate(_port(params), torch.from_numpy(prompt), 6,
                          flash_prefill=flash_prefill)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tie_logits():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    x[1, [2, 5, 7, 11]] = 3.0          # four-way tie at the top
    x[2, [0, 3]] = 2.5                 # tie straddling the 3rd/4th place
    x[2, [1, 9]] = 4.0
    x[3] = 0.0                         # all tied
    return x


@pytest.mark.parametrize("top_k,top_p", [
    (3, 0.0), (5, 0.0), (16, 0.0),      # top-k only
    (0, 0.3), (0, 0.55), (0, 0.9),      # nucleus only
    (4, 0.55), (8, 0.9), (16, 0.8)])    # both
def test_filter_logits_matches_jax(top_k, top_p):
    x = _tie_logits()
    want = np.asarray(jax_filter(jnp.asarray(x), 0.7, top_k, top_p))
    got = filter_logits(torch.from_numpy(x), 0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6)


def test_sampling_is_deterministic_per_seed(params):
    model = _port(params)
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    greedy = greedy_generate(model, prompt, 5)
    assert torch.equal(generate(model, prompt, 5, temperature=0.0), greedy)
    s1 = generate(model, prompt, 8, temperature=2.0, seed=1)
    assert torch.equal(generate(model, prompt, 8, temperature=2.0, seed=1), s1)
    assert not torch.equal(generate(model, prompt, 8, temperature=2.0, seed=2), s1)
    # the greedy limits of the filters
    assert torch.equal(generate(model, prompt, 5, temperature=1.0, top_k=1, seed=7),
                       greedy)
    assert torch.equal(generate(model, prompt, 5, temperature=1.0, top_p=1e-6,
                                seed=5), greedy)
    with pytest.raises(ValueError):
        greedy_generate(model, prompt, 5, temperature=1.0)


def test_bf16_decode_matches_jax(params):
    """bf16 weights, activations and caches: prefill plus decode steps fed
    the tokens JAX's bf16 greedy run chose, logits held at every step."""
    prompt = _prompt(P=8, seed=2)
    toks = np.array(jax_greedy(params, jnp.asarray(prompt), 4, **CFG,
                               dtype=jnp.bfloat16))
    dec = JaxLM(**CFG, dtype=jnp.bfloat16, decode=True, max_len=12)
    shapes = jax.eval_shape(lambda: dec.init(jax.random.PRNGKey(0),
                                             jnp.zeros((2, 1), jnp.int32)))
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes["cache"])
    step = jax.jit(lambda c, t: dec.apply({"params": params, "cache": c}, t,
                                          mutable=["cache"]))
    model = _port(params, torch.bfloat16)
    tcache = model.new_cache(2, 12)
    with torch.no_grad():
        for chunk in [prompt] + [toks[:, i:i + 1] for i in range(3)]:
            want, mut = step(cache, jnp.asarray(chunk))
            cache = mut["cache"]
            got = model(torch.from_numpy(chunk), cache=tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=6e-2, rtol=6e-2)
