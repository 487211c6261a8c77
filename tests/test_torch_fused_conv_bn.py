"""Port's fused conv -> BN backward (K4, K5 and their glue) vs the JAX
package's ``ops/fused_conv_bn.py``, whose Pallas kernels run here in
interpret mode.  On CPU tensors the port's kernel wrappers take their plain
versions, so this holds the plain versions (the arithmetic the CUDA kernels
are held to on the card by ``chip_smoke.py``) against the Pallas kernels.

Sizes are the JAX tests' own (``tests/test_fused_conv_bn.py``): M = 50 rows
(ragged against the JAX tile), small 3x3 planes (5x6, non-square), N = 3.
Weights cross as HWIO -> OIHW.  Tolerances:

- f32: everything to atol 2e-5, rtol 2e-4 (the JAX test's own tolerance
  against its autodiff oracle): the same fold in f32, reduced in another
  order;
- bf16 activations: the forward conv is a bf16 conv in both frameworks,
  rounded at other points, so y, the batch statistics and the vectors
  differ by bf16 ulps; dW, dgamma and dbeta are compared at 2e-2 of their
  largest entry (the JAX test allows 5e-2 against an f32 oracle);
- plain versions vs the Pallas kernels on identical inputs: 1e-5, f32
  sums in another order.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import fused_conv_bn as jfc
from pytorch_distributed_tpu_torch.ops import fused_conv_bn as tfc

EPS = 1e-5


def _hwio_to_oihw(w):
    return torch.tensor(np.asarray(w, np.float32).transpose(3, 2, 0, 1).copy())


def _op_inputs(seed, shape, ks, co=16, wscale=1.0):
    rng = np.random.default_rng(seed)
    ci = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(ks, ks, ci, co)) * wscale).astype(np.float32),
            (rng.normal(size=co) * 0.5 + 1.0).astype(np.float32),
            (rng.normal(size=co) * 0.1).astype(np.float32),
            rng.normal(size=shape[:-1] + (co,)).astype(np.float32))


def _grads_both(ks, a, w, gamma, beta, cot, relu, jdt, tdt):
    jop, top = ((jfc.conv1x1_bn_act, tfc.conv1x1_bn_act) if ks == 1 else
                (jfc.conv3x3_bn_act, tfc.conv3x3_bn_act))

    def jloss(a_, w_, g_, b_):
        o, _, _ = jop(a_, w_, g_, b_, EPS, relu, True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    ja = jnp.asarray(a, jdt)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(ja, jnp.asarray(w), gamma, beta)
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).to(tdt).requires_grad_()
    tw = _hwio_to_oihw(w).requires_grad_()
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    o, mu, var = top(ta, tw, tg, tb, EPS, relu)
    (o.float() * torch.tensor(cot)).sum().backward()
    assert tw.grad.dtype == torch.float32 and ta.grad.dtype == tdt
    got = (ta.grad.float().numpy(), tw.grad.numpy().transpose(2, 3, 1, 0), tg.grad.numpy(),
           tb.grad.numpy())
    return got, [np.asarray(x, np.float32) for x in want]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("ks,shape,wscale", [(1, (2, 5, 5, 24), 1.0), (3, (3, 5, 6, 8), 0.4)],
                         ids=["1x1_M50", "3x3_5x6"])
def test_conv_bn_op_grads_match_jax_f32(ks, shape, wscale, relu):
    a, w, gamma, beta, cot = _op_inputs(ks, shape, ks, wscale=wscale)
    got, want = _grads_both(ks, a, w, gamma, beta, cot, relu, jnp.float32, torch.float32)
    for g, wnt, name in zip(got, want, ("da", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, wnt, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("ks,wscale", [(1, 1.0), (3, 0.4)], ids=["1x1", "3x3"])
def test_conv_bn_op_grads_match_jax_bf16(ks, wscale):
    a, w, gamma, beta, cot = _op_inputs(10 + ks, (4, 4, 4, 32), ks, wscale=wscale)
    got, want = _grads_both(ks, a, w, gamma, beta, cot, True, jnp.bfloat16, torch.bfloat16)
    for g, wnt, name in zip(got[1:], want[1:], ("dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, wnt, atol=2e-2 * np.abs(wnt).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_vectors_match_jax(relu):
    rng = np.random.default_rng(5)
    y = rng.normal(size=(2, 3, 4, 6)).astype(np.float32) * 2 + 0.3
    do = rng.normal(size=y.shape).astype(np.float32)
    mu, var = y.mean((0, 1, 2)), y.var((0, 1, 2))
    inv = (1 / np.sqrt(var + EPS)).astype(np.float32)
    gamma = (rng.normal(size=6) * 0.5 + 1).astype(np.float32)
    beta = (rng.normal(size=6) * 0.2).astype(np.float32)
    want = jfc._bn_bwd_vectors(*(jnp.asarray(x) for x in (y, do, mu, inv, gamma, beta)), relu)
    got = tfc.bn_bwd_vectors(*(torch.tensor(x) for x in (y, do, mu, inv, gamma, beta)), relu)
    for g, wnt, name in zip(got, want, "s t u v dgamma dbeta".split()):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _fold_inputs(seed, lead, ci, co, ks):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (co,)).astype(np.float32),
            rng.normal(size=lead + (co,)).astype(np.float32),
            rng.normal(size=lead + (ci,)).astype(np.float32),
            (rng.normal(size=(ks, ks, ci, co)) * 0.3).astype(np.float32),
            *(rng.normal(size=co).astype(np.float32) for _ in range(4)))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("ks,lead,ci,co", [(1, (50,), 24, 16), (1, (10_000,), 8, 8),
                                           (3, (3, 5, 6), 8, 16)],
                         ids=["k4_M50", "k4_multi_tile", "k5_5x6"])
def test_kernel_wrappers_on_cpu_match_pallas(ks, lead, ci, co, relu):
    """The K4/K5 wrappers on CPU tensors run the plain version (no kernel
    launch is counted) and agree with the Pallas kernels in interpret mode:
    ragged M, dW accumulated over several grid steps, the 3x3 zero-padded
    edges."""
    y, do, a, w, s, t, u, v = _fold_inputs(ks + len(lead), lead, ci, co, ks)
    if ks == 1:
        assert jfc._pick_mtile(int(np.prod(lead)), ci, co, 4) < 10_000 or lead == (50,)
        jda, jdw = jfc._fused_dgrad_wgrad(*(jnp.asarray(x) for x in (y, do, a)),
                                          jnp.asarray(w[0, 0]),
                                          *(jnp.asarray(x) for x in (s, t, u, v)), relu, True)
        jdw = np.asarray(jdw)[None, None]
        wrapper = tfc.fused_dgrad_wgrad
    else:
        jda, jdw = jfc._fused_dgrad_wgrad_3x3(*(jnp.asarray(x) for x in (y, do, a, w, s, t, u, v)),
                                              relu, True)
        wrapper = tfc.fused_dgrad_wgrad_3x3
    before = wrapper.launches
    tda, tdw = wrapper(*(torch.tensor(x) for x in (y, do, a)), _hwio_to_oihw(w),
                       *(torch.tensor(x) for x in (s, t, u, v)), relu)
    assert wrapper.launches == before
    assert tdw.dtype == torch.float32 and tuple(tdw.shape) == (co, ci, ks, ks)
    np.testing.assert_allclose(tda.numpy(), np.asarray(jda), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdw.numpy().transpose(2, 3, 1, 0), np.asarray(jdw),
                               rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    y = torch.zeros(2, 4, 4, 8)
    a = torch.zeros(2, 4, 4, 6)
    vec = [torch.zeros(8)] * 4
    with pytest.raises(ValueError, match="must be"):
        tfc.fused_dgrad_wgrad(y, y, a, torch.zeros(8, 5, 1, 1), *vec, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfc.fused_dgrad_wgrad_3x3(y.to("meta"), y.to("meta"), a.to("meta"),
                                  torch.zeros(8, 6, 3, 3, device="meta"), *vec, True)


def test_plane_rule_matches_jax():
    """The slot-selection rule is the JAX function itself, value for value."""
    for h in (7, 14, 28, 56, 112):
        for ci, co in ((64, 64), (128, 128), (256, 256), (512, 512)):
            for itemsize in (2, 4):
                assert (tfc.conv3x3_plane_fits_vmem(h, h, ci, co, itemsize)
                        == jfc.conv3x3_plane_fits_vmem(h, h, ci, co, itemsize))


def test_bf16_width_limit_matches_the_kernel_and_spares_folded_planes():
    """``_TC_MAX_W`` is the widest plane whose wgrad halo ring fits the
    kernel's shared memory (``wgrad3_smem`` against ``MAX_SMEM``, read from
    the source), and every square plane the slot rule folds lies inside it."""
    src = (Path(tfc.__file__).parent.parent / "csrc" / "fused_conv_bn_bwd.cu").read_text()
    c = {k: int(re.search(rf"constexpr \w+ {k} = (\d+);", src).group(1))
         for k in ("TC_ROW", "WG_SC", "WG_ST", "MAX_SMEM")}
    yb = c["WG_SC"] * c["TC_ROW"]

    def smem(w):  # 1024 bytes to align the tiles, the stages, the zero row and (s, t, u, v)
        return (1024 + c["WG_ST"] * (2 * yb + (c["WG_SC"] + 2 * w + 2) * c["TC_ROW"])
                + c["TC_ROW"] + 1024)

    assert smem(tfc._TC_MAX_W) <= c["MAX_SMEM"] < smem(tfc._TC_MAX_W + 1)
    for ch in (64, 128, 256, 512):
        for w in range(tfc._TC_MAX_W + 1, 4 * tfc._TC_MAX_W):
            assert not tfc.conv3x3_plane_fits_vmem(w, w, ch, ch, 2)


def test_wgrad_split_covers_every_row():
    """Both split rules: the CUDA-core wgrad's (16-pixel chunks) and the
    bf16 3x3 tensor-core wgrad's (128-pixel chunks, all taps in a CTA)."""
    for M, ci, co, taps in ((802_816, 256, 64, 1), (802_816, 64, 64, 9),
                            (12_544, 2048, 512, 1), (297, 70, 33, 9), (1, 8, 8, 1),
                            (12_544, 512, 512, 9), (50_176, 256, 256, 9)):
        for tensor_cores, chunk in ((False, 16), (True, 128)):
            splits, rows = tfc._wgrad_split(M, ci, co, taps, tensor_cores=tensor_cores)
            assert 1 <= splits <= 65535 and rows % chunk == 0
            assert (splits - 1) * rows < M <= splits * rows
