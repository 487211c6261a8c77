"""Port's fused conv -> BN backward (K4, K5 and their glue) vs the JAX
package's ``ops/fused_conv_bn.py``, whose Pallas kernels run here in
interpret mode.  On CPU tensors the port's kernel wrappers take their plain
versions, so this holds the plain versions (the arithmetic the CUDA kernels
are held to on the card by ``chip_smoke.py``) against the Pallas kernels.

Sizes are the JAX tests' own (``tests/test_fused_conv_bn.py``): M = 50 rows
(ragged against the JAX tile), small 3x3 planes (5x6, non-square), N = 3;
and planes far wider than tall (2x40, 3x17), as the slot rule folds them.
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
from tests.test_torch_zoo import FAST_COMPILE

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
    # One program (FAST_COMPILE) rather than op by op: the same f32
    # arithmetic, and each case compiles once instead of every op of it.
    args = (ja, jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3))).lower(*args).compile(
        FAST_COMPILE)(*args)
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
@pytest.mark.parametrize("ks,shape,wscale", [(1, (2, 5, 5, 24), 1.0), (3, (3, 5, 6, 8), 0.4),
                                             (3, (2, 2, 40, 8), 0.4), (3, (2, 3, 17, 8), 0.4)],
                         ids=["1x1_M50", "3x3_5x6", "3x3_2x40", "3x3_3x17"])
def test_conv_bn_op_grads_match_jax_f32(ks, shape, wscale, relu):
    a, w, gamma, beta, cot = _op_inputs(ks, shape, ks, wscale=wscale)
    got, want = _grads_both(ks, a, w, gamma, beta, cot, relu, jnp.float32, torch.float32)
    for g, wnt, name in zip(got, want, ("da", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, wnt, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("ks,wscale,shape", [(1, 1.0, (4, 4, 4, 32)), (3, 0.4, (4, 4, 4, 32)),
                                             (3, 0.4, (2, 2, 40, 32)), (3, 0.4, (2, 3, 17, 32))],
                         ids=["1x1", "3x3", "3x3_2x40", "3x3_3x17"])
def test_conv_bn_op_grads_match_jax_bf16(ks, wscale, shape):
    a, w, gamma, beta, cot = _op_inputs(10 + ks, shape, ks, wscale=wscale)
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


def _kernel_source():
    return (Path(tfc.__file__).parent.parent / "csrc" / "fused_conv_bn_bwd.cu").read_text()


def test_bf16_3x3_smem_fits_every_folded_width():
    """Both bf16 3x3 kernels fit a CTA's shared memory at every plane width
    the slot rule folds, up to its widest plane (h = 1) at 64, 128, 256 and
    512 channels: their footprints (``dgrad3_smem``, ``wgrad3_smem`` and the
    layout rule ``k5_banded``, with the constants read from the kernel
    source) against ``MAX_SMEM``.  ResNet-50's planes (up to 56 wide) keep
    the contiguous halo."""
    src = _kernel_source()
    c = {k: int(re.search(rf"constexpr \w+ {k} = (\d+);", src).group(1))
         for k in ("TC_ROW", "DW_G", "DG_WS", "WG_SC", "WG_ST", "MAX_SMEM")}
    for formula in ("BAND_ROWS = WG_SC + 2;", "DW_TM = 64 * DW_G;",
                    "halo = band ? 3 * BAND_ROWS : DW_TM + 2 * g.W + 2;",
                    "return 1024 + DG_WS * nb * TAP_BYTES + TC_ROW + 1024 + halo * TC_ROW;",
                    "a_stages = band ? 2 : WG_ST, halo = band ? 3 * BAND_ROWS : WG_SC + 2 * g.W + 2;",
                    "return 1024 + WG_ST * 2 * WG_YB + a_stages * halo * TC_ROW + TC_ROW + 1024;",
                    "return wgrad3_smem(g, false) > MAX_SMEM;"):
        assert formula in src, formula
    from pytorch_distributed_tpu_torch.tools.k5_halo_layouts import _RULE

    assert _RULE in src   # the layout A/B tool rewrites this rule
    row, band_rows = c["TC_ROW"], c["WG_SC"] + 2

    def dgrad3(w, nb, band):
        halo = 3 * band_rows if band else 64 * c["DW_G"] + 2 * w + 2
        return 1024 + c["DG_WS"] * nb * 64 * row + row + 1024 + halo * row

    def wgrad3(w, band):
        halo = 3 * band_rows if band else c["WG_SC"] + 2 * w + 2
        return (1024 + c["WG_ST"] * 2 * c["WG_SC"] * row + (2 if band else c["WG_ST"]) * halo * row
                + row + 1024)

    def banded(w):
        return wgrad3(w, False) > c["MAX_SMEM"]

    assert not banded(56) and banded(2656)
    for ch, widest in ((64, 2656), (128, 2656), (256, 1219), (512, 392)):
        assert tfc.conv3x3_plane_fits_vmem(1, widest, ch, ch, 2)
        assert not tfc.conv3x3_plane_fits_vmem(1, widest + 1, ch, ch, 2)
        for w in range(1, widest + 1):
            band = banded(w)
            assert max(dgrad3(w, 1, band), dgrad3(w, 2, band), wgrad3(w, band)) <= c["MAX_SMEM"], w


@pytest.mark.parametrize("tensor_cores,chunk", [(False, 16), (True, 128), (True, 64)],
                         ids=["cuda_cores", "tensor_cores_3x3", "tensor_cores_1x1"])
def test_wgrad_split_covers_every_row(tensor_cores, chunk):
    """Each split rule over the grids its kernels report: the CUDA-core
    wgrad's (16-pixel chunks, a CTA per tap and 64 x 64 tile), the bf16 3x3
    tensor-core wgrad's (128-pixel chunks) and the bf16 1x1 one's (64)."""
    for M in (802_816, 200_704, 50_176, 12_544, 297, 1):
        for tiles in (1, 2, 4, 9, 16, 36, 64, 132, 264, 265, 2304):
            splits, rows = tfc._wgrad_split(M, tiles, chunk, tensor_cores=tensor_cores)
            assert 1 <= splits <= 65535 and rows % chunk == 0
            assert (splits - 1) * rows < M <= splits * rows


def test_wgrad_grid_is_decided_by_the_kernel_source():
    """The wrapper takes the wgrad grid's CTAs per slice and pixel chunk
    from the kernel source's ``ptd_fused_conv_bn_wgrad_tiles`` (the launch
    grids' own expressions), and keeps no copy of the tile shapes."""
    src = _kernel_source()
    body = src[src.index('extern "C" int ptd_fused_conv_bn_wgrad_tiles'):]
    body = body[:body.index("\n}\n")]
    for grid, chunk in (("((Ci + TN - 1) / TN) * ((Co + TM - 1) / TM)", "TK"),
                        ("((Ci + 63) / 64) * ((Co + 63) / 64)", "WG_SC"),
                        ("((Ci + K4_WCI - 1) / K4_WCI) * ((Co + tn - 1) / tn)", "K4_WP")):
        assert grid in body and f"*chunk = {chunk};" in body
    assert "const int tn = k4_width(Co);" in body and "dn = k4_width(Ci), wn = k4_width(Co)" in src
    for launcher in ("const dim3 wgrid(((Ci + TN - 1) / TN) * ((Co + TM - 1) / TM), KS * KS",
                     "const dim3 wgrid(((Ci + 63) / 64) * ((Co + 63) / 64), splits);",
                     "const dim3 wgrid(((Ci + K4_WCI - 1) / K4_WCI) * ((Co + TN - 1) / TN), splits);"):
        assert launcher in src, launcher
    assert "k4_width" not in Path(tfc.__file__).read_text()


def test_image_profile_files_every_conv_bn_kernel():
    """``tools/profile_image_train`` files each kernel of the conv-BN source
    under K4, K5 or their split reduction, by the names the profiler
    reports (its K4 class is the per-step figure K4's speed is judged by)."""
    from pytorch_distributed_tpu_torch.tools.profile_image_train import _classify

    want = {"dgrad_kernel<1>": "K4", "wgrad_kernel<1>": "K4",
            "dgrad_kernel<3>": "K5", "wgrad_kernel<3>": "K5",
            "dgrad1_mma_kernel<true, 256>": "K4", "wgrad1_mma_kernel<false, 64>": "K4",
            "dgrad3_mma_kernel<true, 1, false>": "K5", "dgrad3_mma_kernel<false, 2, true>": "K5",
            "wgrad3_mma_kernel<true, false>": "K5",
            "sum_splits_kernel": "K4/K5 split reduction"}
    defined = set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                             _kernel_source()))
    assert defined == {name.split("<")[0] for name in want}
    for name, cls in want.items():
        assert _classify(f"void (anonymous namespace)::{name}(const float*, int)") == cls, name
