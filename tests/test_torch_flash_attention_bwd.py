"""Port's flash-attention backward (CPU path: the plain version behind the
autograd Function) vs the JAX Pallas backward kernels in interpret mode.

The CUDA kernels K2 and K3 run only on the card; chip_smoke.py holds them
against the same plain version there.  Tolerances: f32 1e-4 (both sides
recompute p from the saved lse in f32; the sums run in another order and
the JAX kernels tile them 32 x 32); bf16 0.05, the JAX package's own
Pallas-vs-XLA bf16 backward tolerance (the gradients are rounded to bf16
and the inputs of every product are bf16 on the JAX side); plain backward
vs autograd through the plain forward 1e-5 (the same f32 arithmetic,
reassociated by the blockwise recompute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    _FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fn,
    flash_attention_reference,
)


def _inputs(B=2, L=128, H=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(4)]


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = flash_attention_fn(*ts, causal)
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [t.grad for t in ts]


def _jax_grads(q, k, v, g, causal, dtype=jnp.float32):
    def f(q, k, v):
        return jax_flash(q, k, v, causal, 32, 32, True, "pallas")

    _, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return vjp(jnp.asarray(g, dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_pallas_kernels(causal):
    """L=128 in 32 x 32 blocks: the Pallas dq and dk/dv kernels accumulate
    across a 4 x 4 block grid, with the causal block skip live."""
    q, k, v, g = _inputs()
    out, got = _port_grads(q, k, v, g, causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    want = _jax_grads(q, k, v, g, causal)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_backward_bf16_matches_jax_pallas_kernels():
    q, k, v, g = _inputs(B=1, H=1, D=64, seed=4)
    _, got = _port_grads(q, k, v, g, True, torch.bfloat16)
    want = _jax_grads(q, k, v, g, True, jnp.bfloat16)
    for a, b, name in zip(got, want, "qkv"):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=5e-2, atol=5e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_at_ragged_length(causal):
    """L=200 is no multiple of any tile: the plain backward, and the two
    per-kernel wrappers on the CPU, against autograd through the plain
    forward."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(L=200, D=64, seed=2))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = flash_attention_reference(*ts, causal)
    out.backward(g)
    want = [t.grad for t in ts]
    out, lse = flash_attention_reference(q, k, v, causal)
    got = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    delta = (out * g).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    for grads in (got, (dq, dk, dv), flash_attention_bwd(q, k, v, out, lse, g, causal)):
        for a, b, name in zip(grads, want, "qkv"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"d{name}")


def test_backward_counts_no_launch_on_cpu_and_lse_has_no_gradient():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(L=16))
    before = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = _FlashAttention.apply(*ts, True)
    assert out.requires_grad and not lse.requires_grad
    out.backward(g)
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, q, torch.zeros(2, 2, 16), g[:, :8])
    with pytest.raises(ValueError, match="lse and delta"):
        flash_attention_bwd_dq(q, k, v, g, torch.zeros(2, 16, 2), torch.zeros(2, 2, 16))
