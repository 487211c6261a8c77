"""Port's flash attention (CPU path: the plain version) vs the JAX Pallas
forward kernel in interpret mode.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
the same plain version there.  Tolerances: f32 2e-5 (both sides compute the
same f32 online/plain softmax, only the summation order differs); bf16
inputs 2e-2 (outputs are rounded to bf16, one ulp is up to ~1.6e-2 at the
output magnitudes here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import _flash_fwd
from pytorch_distributed_tpu.parallel.ring import dense_attention as jax_dense
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
    pick_attention_impl,
)
from pytorch_distributed_tpu_torch.parallel.ring import dense_attention


def _qkv(B=2, L=256, H=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel(causal):
    """Several 128-blocks, so the causal block skip of the JAX kernel is
    live; out and lse both compared."""
    q, k, v = _qkv()
    want_out, want_lse = _flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal, 128, 128, True)
    out, lse = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=2e-5)
    B, L, H, _ = q.shape
    np.testing.assert_allclose(lse.numpy().reshape(B * H, L),
                               np.asarray(want_lse), atol=2e-5, rtol=2e-5)


def test_flash_bf16_matches_jax_kernel():
    q, k, v = _qkv(seed=1)
    want_out, want_lse = _flash_fwd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, 128, 128, True)
    out, lse = flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy().reshape(4, 256),
                               np.asarray(want_lse), atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_length_matches_jax_dense(causal):
    """A length no block size divides (the kernel masks its last tile);
    the JAX kernel needs aligned lengths, so JAX dense attention is the
    oracle here, and the port's dense attention must agree too."""
    q, k, v = _qkv(L=200, D=64, seed=2)
    want = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q, k, v)), causal))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dense_attention(tq, tk, tv, causal).numpy(), want,
                               atol=2e-5, rtol=2e-5)
    assert lse.shape == (2, 2, 200) and torch.isfinite(lse).all()


def test_flash_counts_no_launch_on_cpu():
    before = flash_attention.launches
    flash_attention(*(torch.from_numpy(x) for x in _qkv(L=16)))
    assert flash_attention.launches == before


def test_flash_rejects_mismatched_inputs():
    q, k, _ = (torch.from_numpy(x) for x in _qkv(L=16))
    with pytest.raises(ValueError):
        flash_attention(q, k, k[:, :8])
    with pytest.raises(ValueError):
        flash_attention(q, k.double(), k)


def test_pick_attention_impl_mirrors_jax_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pick_attention_impl(4096, 64, cuda) == "flash"
    assert pick_attention_impl(8192, 128, cuda) == "flash"
    assert pick_attention_impl(4096 + 512, 64, cuda) == "dense"
    assert pick_attention_impl(2048, 64, cuda) == "dense"
    assert pick_attention_impl(4096, 64, cpu) == "dense"
    # auto never picks the kernel for a head dim it does not take
    assert pick_attention_impl(4096, 32, cuda) == "dense"
