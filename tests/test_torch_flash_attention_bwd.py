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
    NEG_INF,
    _FlashAttention,
    _bwd_blockwise,
    _check_16b_aligned,
    _delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fn,
    flash_attention_reference,
)
from tests.test_torch_zoo import FAST_COMPILE


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

    def grads(q, k, v, g):
        return jax.vjp(f, q, k, v)[1](g)

    # One program (FAST_COMPILE) rather than op by op: the same arithmetic,
    # compiled once instead of every op of the interpreted kernels.
    args = tuple(jnp.asarray(x, dtype) for x in (q, k, v, g))
    return jax.jit(grads).lower(*args).compile(FAST_COMPILE)(*args)


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


def _bwd_bf16_p_ds(q, k, v, out, lse, dout, causal):
    """The bf16 tensor-core kernels' arithmetic in plain PyTorch: s, p, dp
    and ds in f32 from the bf16 inputs, p and ds rounded to bf16 where they
    enter the second products (dv = p^T dO, dk = ds^T q, dq = ds k), each
    product of bf16 values summed in f32.  Returns f32 (dq, dk, dv)."""
    L, D = q.shape[1], q.shape[-1]
    scale = 1.0 / D ** 0.5
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, dout))
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        pos = torch.arange(L)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (gf @ vf.transpose(-1, -2) - _delta(out, dout)[..., None]) * scale
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    grads = (dsb @ kf, dsb.transpose(-1, -2) @ qf, pb.transpose(-1, -2) @ gf)
    return tuple(g.transpose(1, 2) for g in grads)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_ds_rounding_inside_card_tolerance(causal):
    """Basis of the card's bf16 tolerance for K2/K3 (chip_smoke.py phase 5):
    |kernel - plain| <= 4e-3 max|plain| + 1e-2 |plain| per element and a
    relative Frobenius error <= 5e-3 per gradient.  The kernels round p and
    ds to bf16 before the second products, where the plain version keeps
    them f32; both round their outputs to bf16.  Emulated here at L=512:
    the rounding of p and ds alone (outputs compared in f32) costs
    ~1.7e-3 relative Frobenius error and at most ~1.4e-3 of max|grad| past
    rtol 1e-2; both must sit inside half the card's bounds.  The bf16
    outputs compared as the card compares them add each side's own output
    rounding (~1.7e-3 Frobenius alone), ~2.6e-3 in all: inside 5e-3, and
    every element inside half the elementwise bound."""
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 512, 2, 64)).astype(np.float32))
                  .bfloat16() for _ in range(4))
    out, lse = flash_attention_reference(q, k, v, causal)
    emulated = _bwd_bf16_p_ds(q, k, v, out, lse, g, causal)
    plain = _bwd_blockwise(q, k, v, g, lse, _delta(out, g), causal)
    for a, b, name in zip(emulated, plain, "qkv"):
        for a, b, frob_limit in ((a, b, 2.5e-3),
                                 (a.bfloat16().float(), b.bfloat16().float(), 5e-3)):
            err = (a - b).abs()
            bound = 0.5 * (4e-3 * b.abs().max() + 1e-2 * b.abs())
            assert bool((err <= bound).all()), f"d{name}: {(err / bound).max():.3f}x half the bound"
            frob = ((a - b).norm() / b.norm()).item()
            assert frob <= frob_limit, f"d{name}: relative Frobenius error {frob:.3e}"


def test_bf16_kernels_need_16_byte_alignment():
    """The bf16 kernels copy 16 bytes at a time: the wrapper raises on a
    base pointer or a (b, l, h) stride that is not a multiple of 16 bytes,
    and takes the fused qkv projection's strided views."""
    qkv = torch.zeros(2, 8, 3, 2, 64, dtype=torch.bfloat16)
    _check_16b_aligned("k", *qkv.unbind(2))
    flat = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_16b_aligned("k", flat[1:].view(2, 8, 2, 64))
    _check_16b_aligned("k", torch.zeros(2, 8, 2, 72, dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_16b_aligned("k", torch.zeros(2, 8, 2, 66, dtype=torch.bfloat16)[..., :64])
