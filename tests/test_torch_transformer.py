"""Port's TransformerLM vs the JAX TransformerLM on the same weights.

Weights cross through ``lm_state_dict_from_jax``; inputs are numpy-seeded.
Tolerance 2e-4 in f32 (the JAX package's own decode-vs-full tolerance: the
two frameworks order matmul and softmax sums differently); bf16 6e-2 (bf16
rounds each layer's activations to 8 bits of mantissa, at different points
in the two frameworks, and the errors add over 2 layers and the head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import rope as jax_rope
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM, rope
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _jax_decoder(max_len, flash_prefill=False):
    """(zeroed JAX cache, jitted cached step) for the JAX decode model."""
    dec = JaxLM(**CFG, decode=True, max_len=max_len, flash_prefill=flash_prefill)
    shapes = jax.eval_shape(lambda: dec.init(jax.random.PRNGKey(0),
                                             jnp.zeros((2, 1), jnp.int32)))
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes["cache"])

    @jax.jit
    def step(params, cache, tokens):
        out, mut = dec.apply({"params": params, "cache": cache}, tokens,
                             mutable=["cache"])
        return out, mut["cache"]

    return cache, step


def _port(params, dtype=torch.float32):
    model = TransformerLM(**CFG, dtype=dtype, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    return model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 64, size=shape).astype(np.int32)


def test_rope_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(rope(torch.from_numpy(x), offset=7).numpy(),
                               np.asarray(jax_rope(jnp.asarray(x), offset=7)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, TOL), (torch.bfloat16, dict(rtol=6e-2, atol=6e-2))])
def test_full_forward_matches_jax(params, dtype, tol):
    tokens = _tokens((2, 12), 0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax.jit(JaxLM(**CFG, dtype=jdt).apply)({"params": params},
                                                  jnp.asarray(tokens))
    with torch.no_grad():
        got = _port(params, dtype)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_decode_prefill_and_steps_match_jax(params):
    """Prefill 4 tokens, then one token at a time: logits at every step and
    the final caches against the JAX decode model."""
    tokens = _tokens((2, 12), 1)
    cache, step = _jax_decoder(12)
    model = _port(params)
    tcache = model.new_cache(2, 12)
    chunks = [(0, 4)] + [(t, t + 1) for t in range(4, 12)]
    with torch.no_grad():
        for a, b in chunks:
            want, cache = step(params, cache, jnp.asarray(tokens[:, a:b]))
            got = model(torch.from_numpy(tokens[:, a:b]), cache=tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_equal(cache, tcache)


def _assert_cache_equal(jax_cache, port_cache):
    for i, c in enumerate(port_cache):
        jc = jax_cache[f"block_{i}"]["attn"]
        assert c.index == int(jc["cache_index"])
        np.testing.assert_allclose(c.key.float().numpy(),
                                   np.asarray(jc["cached_key"], np.float32), **TOL)
        np.testing.assert_allclose(c.value.float().numpy(),
                                   np.asarray(jc["cached_value"], np.float32), **TOL)


def test_flash_prefill_matches_jax_flash_prefill(params):
    """P=256 prompt through the flash branch on both sides (JAX: Pallas in
    interpret mode), then one dense decode step on the filled cache."""
    P, EXTRA = 256, 4
    tokens = _tokens((2, P), 2)
    nxt = _tokens((2, 1), 3)
    cache, step = _jax_decoder(P + EXTRA, flash_prefill=True)
    want, cache = step(params, cache, jnp.asarray(tokens))
    want_step, _ = step(params, cache, jnp.asarray(nxt))
    model = _port(params)
    tcache = model.new_cache(2, P + EXTRA)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), cache=tcache, flash_prefill=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_cache_equal(cache, tcache)
        got_step = model(torch.from_numpy(nxt), cache=tcache, flash_prefill=True)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), **TOL)


def test_flash_prefill_needs_cache_index_zero(params):
    model = _port(params)
    cache = model.new_cache(1, 8)
    with torch.no_grad():
        model(torch.zeros((1, 1), dtype=torch.int32), cache=cache)
        with pytest.raises(ValueError, match="index 0"):
            model(torch.zeros((1, 2), dtype=torch.int32), cache=cache,
                  flash_prefill=True)
        with pytest.raises(ValueError, match="overflow"):
            model(torch.zeros((1, 8), dtype=torch.int32), cache=cache)
