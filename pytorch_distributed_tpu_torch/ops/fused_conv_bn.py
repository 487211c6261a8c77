"""Fused conv -> BN(+ReLU) backward: hand-written Hopper kernels and their
plain versions, the port of ``pytorch_distributed_tpu/ops/fused_conv_bn.py``.

For a stride-1 conv (1x1, or 3x3 SAME) whose output feeds BatchNorm, the
backward folds BN's input gradient ``dy`` into the conv's dgrad and wgrad:
per channel, ``dy = s * dof + t * y + u`` with ``dof`` the (ReLU-masked)
output gradient, so the products can recompute dy from (y, dout) and four
per-channel vectors instead of reading a dy written to device memory.

- ``bn_bwd_vectors`` reduces dgamma, dbeta and the vectors s, t, u, v in
  plain PyTorch (the JAX ``_bn_bwd_vectors``).  Under a process group
  (global-batch BatchNorm, the JAX GSPMD step) dgamma, dbeta and the count
  are summed over the ranks before t and u are formed, so the kernels see
  the globally reduced vectors; the dgamma, dbeta and dW returned stay this
  rank's sums, for the step's gradient all-reduce.
- K4 ``fused_dgrad_wgrad`` (1x1) and K5 ``fused_dgrad_wgrad_3x3`` launch
  ``csrc/fused_conv_bn_bwd.cu`` on CUDA tensors, with a launch counter each
  (bf16 on the tensor cores, f32 on the CUDA cores);
  CPU tensors take their plain versions ``fused_dgrad_wgrad_reference`` and
  ``fused_dgrad_wgrad_3x3_reference`` (the 9 shifted products of the JAX
  ``_bwd3_kernel``).
- ``conv1x1_bn_act`` / ``conv3x3_bn_act``: autograd Functions (the JAX
  ``custom_vjp`` ops): forward ``F.conv2d`` + the BN forward of
  ``ops/fused_bn.py``; backward ``bn_bwd_vectors`` + the kernel.
- ``conv_bn``: the model-level combinator (the JAX ``conv1x1_bn``), which
  takes the fused op only in training mode, for the slots it applies to.

Layout: activations NHWC (``[N, H, W, C]``, as the JAX package), weights
PyTorch's OIHW ``[Co, Ci, kh, kw]`` in f32; dW comes back f32 OIHW.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.fused_bn import bn_act_fwd, global_sums

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Work split of the wgrad over pixel slices; the kernel source reports its
# grid's CTAs per slice and pixel chunk (``_wgrad_tiles``).  The CUDA-core
# wgrad: about 4 CTAs in flight per SM of the H100's 132, with at least 256
# pixels per slice.  The bf16 tensor-core wgrads run one CTA per SM: about
# two full waves, with no partial wave when the channel tiles allow it.
_TARGET_CTAS = 4 * 132
_MIN_SLICE_ROWS = 256
_TC_WAVES = 2


def bn_bwd_vectors(y, do, mu, inv, gamma, beta, relu: bool, group=None):
    """``(s, t, u, v, dgamma, dbeta)``, f32 per channel, for ``y, do
    [..., C]``: ``dy = s * dof + t * y + u`` with ``t = -s * inv * dgamma /
    n``, ``u = -s * dbeta / n - t * mu``; the ReLU mask is ``s * y + v > 0``
    with ``v = beta - s * mu``.  Under ``group``, t and u take dgamma, dbeta
    and n summed over its ranks; the dgamma and dbeta returned are this
    rank's."""
    axes = tuple(range(y.dim() - 1))
    n = y.numel() // y.shape[-1]
    yf, dof = y.float(), do.float()
    s = gamma * inv
    v = beta - s * mu
    if relu:
        dof = torch.where(yf * s + v > 0, dof, 0.0)
    dbeta = dof.sum(axes)
    dgamma = (dof * ((yf - mu) * inv)).sum(axes)
    dbeta_g, dgamma_g, n_g = global_sums(dbeta, dgamma, n, group)
    t = -(s * inv) * (dgamma_g / n_g)
    u = -s * (dbeta_g / n_g) - t * mu
    return s, t, u, v, dgamma, dbeta


def _dy(y, do, s, t, u, v, relu: bool, dtype: torch.dtype) -> torch.Tensor:
    """dy = s * dof + t * y + u in f32, rounded to ``dtype`` (the kernels'
    prologue)."""
    yf, dof = y.float(), do.float()
    if relu:
        dof = torch.where(yf * s + v > 0, dof, 0.0)
    return (dof * s + yf * t + u).to(dtype)


def fused_dgrad_wgrad_reference(y, do, a, w, s, t, u, v, relu: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``(da [..., Ci] in a's dtype, dW f32 [Co, Ci, 1,
    1])`` for the 1x1 conv of ``a [..., Ci]`` with ``w [Co, Ci, 1, 1]`` whose
    output ``y [..., Co]`` fed BN.  Products in f32 of the input-dtype
    values."""
    Co, Ci = w.shape[0], w.shape[1]
    dy = _dy(y, do, s, t, u, v, relu, a.dtype).reshape(-1, Co).float()
    wf = w.reshape(Co, Ci).to(a.dtype).float()
    da = (dy @ wf).to(a.dtype).reshape(a.shape)
    dw = dy.t() @ a.reshape(-1, Ci).float()
    return da, dw.reshape(Co, Ci, 1, 1)


def fused_dgrad_wgrad_3x3_reference(y, do, a, w, s, t, u, v, relu: bool
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: ``(da [N, H, W, Ci], dW f32 [Co, Ci, 3, 3])`` for
    the 3x3 stride-1 SAME conv, as the 9 shifted products of the JAX
    ``_bwd3_kernel`` over zero-padded dy and a."""
    N, H, W, Co = y.shape
    Ci = a.shape[-1]
    dy = _dy(y, do, s, t, u, v, relu, a.dtype).float()
    dyp = F.pad(dy, (0, 0, 1, 1, 1, 1))
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(a.dtype).float()
    dy2 = dy.reshape(-1, Co)
    dx = torch.zeros(N * H * W, Ci, dtype=torch.float32, device=a.device)
    dw = torch.empty(Co, Ci, 3, 3, dtype=torch.float32, device=a.device)
    for kh in range(3):
        for kw in range(3):
            # dgrad: dx[p, q] += dy[p - kh + 1, q - kw + 1] @ W[kh, kw]
            sh = dyp[:, 2 - kh:2 - kh + H, 2 - kw:2 - kw + W, :].reshape(-1, Co)
            dx += sh @ wf[:, :, kh, kw]
            # wgrad: dW[kh, kw] = dy[p, q]^T @ a[p + kh - 1, q + kw - 1]
            sa = ap[:, kh:kh + H, kw:kw + W, :].reshape(-1, Ci)
            dw[:, :, kh, kw] = dy2.t() @ sa
    return dx.reshape(N, H, W, Ci).to(a.dtype), dw


def _wgrad_split(M: int, tiles: int, chunk: int, tensor_cores: bool = False
                 ) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the kernel's wgrad pixel slices, for
    a wgrad grid of ``tiles`` CTAs per slice over ``chunk``-pixel chunks:
    the CUDA-core wgrad's rule, or the bf16 tensor-core wgrads'."""
    if tensor_cores:
        splits = max(1, min(_TC_WAVES * 132 // tiles, -(-M // chunk)))
    else:
        splits = max(1, min(-(-_TARGET_CTAS // tiles), -(-M // _MIN_SLICE_ROWS)))
    rows = -(-M // splits)
    rows = -(-rows // chunk) * chunk
    return -(-M // rows), rows


@functools.cache
def _kernel():
    """The kernels' C entry point, built, loaded and typed on first use."""
    fn = _build.load("fused_conv_bn_bwd").ptd_fused_conv_bn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


@functools.cache
def _wgrad_tiles(Ci: int, Co: int, ks: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(CTAs per pixel slice, pixel chunk)`` of the wgrad grid the kernel
    source picks for these channels, taps and dtype."""
    fn = _build.load("fused_conv_bn_bwd").ptd_fused_conv_bn_wgrad_tiles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    chunk = ctypes.c_int()
    tiles = fn(Ci, Co, ks, _KERNEL_DTYPES[dtype], ctypes.byref(chunk))
    return tiles, chunk.value


def _check(name, y, do, a, w, ks: int) -> None:
    if not (y.shape == do.shape and y.shape[:-1] == a.shape[:-1]):
        raise ValueError(f"{name}: y and do must share a shape and a its leading dims, "
                         f"got {tuple(y.shape)}, {tuple(do.shape)}, {tuple(a.shape)}")
    if tuple(w.shape) != (y.shape[-1], a.shape[-1], ks, ks):
        raise ValueError(f"{name}: w must be [Co, Ci, {ks}, {ks}] = "
                         f"{[y.shape[-1], a.shape[-1], ks, ks]}, got {list(w.shape)}")
    if ks == 3 and y.dim() != 4:
        raise ValueError(f"{name}: the 3x3 fold takes [N, H, W, C] tensors")
    if not (y.dtype == do.dtype == a.dtype and y.device == do.device == a.device == w.device):
        raise ValueError(f"{name}: y, do and a must share dtype and device")
    if a.device.type == "cpu":
        return
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    if a.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, not {a.dtype}")
    if not (y.is_contiguous() and do.is_contiguous() and a.is_contiguous()):
        raise ValueError(f"{name}: the kernel needs contiguous NHWC y, do and a")
    if y.numel() // y.shape[-1] >= 2 ** 31:
        raise ValueError(f"{name}: more pixels than the kernel indexes")


def _launch(name: str, y, do, a, w, s, t, u, v, relu: bool, ks: int):
    """One launch of the kernel for a 1x1 (ks=1) or 3x3 (ks=3) fold."""
    Co, Ci = w.shape[0], w.shape[1]
    if ks == 1:
        N, H, W = y.numel() // Co, 1, 1
        wt = w.to(a.dtype).reshape(1, Co, Ci).contiguous()
    else:
        N, H, W = y.shape[:3]
        wt = w.to(a.dtype).permute(2, 3, 0, 1).contiguous()   # [kh, kw, Co, Ci]
    M = N * H * W
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    dw = torch.empty((ks * ks, Co, Ci), dtype=torch.float32, device=a.device)
    if M == 0:
        return da, dw.zero_()
    vec = torch.stack([s, t, u, v]).float().contiguous()
    splits, rows = _wgrad_split(M, *_wgrad_tiles(Ci, Co, ks, a.dtype),
                                tensor_cores=a.dtype == torch.bfloat16)
    scratch = (torch.empty((splits, ks * ks, Co, Ci), dtype=torch.float32, device=a.device)
               if splits > 1 else dw)
    with torch.cuda.device(a.device):
        err = _kernel()(y.data_ptr(), do.data_ptr(), a.data_ptr(), wt.data_ptr(),
                        vec.data_ptr(), da.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
                        N, H, W, Ci, Co, ks, _KERNEL_DTYPES[a.dtype], int(relu), splits,
                        rows, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    return da, dw


def fused_dgrad_wgrad(y, do, a, w, s, t, u, v, relu: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(da, dW f32 [Co, Ci, 1, 1])`` of the 1x1 conv that fed BN, in
    one pass over (y, do, a) per product.  CUDA tensors launch the kernel;
    CPU tensors take the plain version.  ``fused_dgrad_wgrad.launches``
    counts kernel launches."""
    _check("fused_dgrad_wgrad", y, do, a, w, 1)
    if a.device.type == "cpu":
        return fused_dgrad_wgrad_reference(y, do, a, w, s, t, u, v, relu)
    da, dw = _launch("fused_dgrad_wgrad", y, do, a, w, s, t, u, v, relu, 1)
    fused_dgrad_wgrad.launches += 1
    return da, dw.reshape(w.shape[0], w.shape[1], 1, 1)


def fused_dgrad_wgrad_3x3(y, do, a, w, s, t, u, v, relu: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(da [N, H, W, Ci], dW f32 [Co, Ci, 3, 3])`` of the 3x3 stride-1
    SAME conv that fed BN.  CUDA tensors launch the kernel; CPU tensors take
    the plain version.  ``fused_dgrad_wgrad_3x3.launches`` counts kernel
    launches."""
    _check("fused_dgrad_wgrad_3x3", y, do, a, w, 3)
    if a.device.type == "cpu":
        return fused_dgrad_wgrad_3x3_reference(y, do, a, w, s, t, u, v, relu)
    da, dw = _launch("fused_dgrad_wgrad_3x3", y, do, a, w, s, t, u, v, relu, 3)
    fused_dgrad_wgrad_3x3.launches += 1
    return da, dw.reshape(3, 3, w.shape[0], w.shape[1]).permute(2, 3, 0, 1).contiguous()


fused_dgrad_wgrad.launches = 0
fused_dgrad_wgrad_3x3.launches = 0


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
                groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on an NHWC tensor (viewed as channels-last NCHW, the
    same memory), returning NHWC; w is OIHW in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _make_conv_bn_op(ks: int, dgrad_wgrad):
    """``(o, mu, var) = BN+ReLU(conv_ks(a, w))`` as an autograd Function
    whose backward is ``bn_bwd_vectors`` then ``dgrad_wgrad``; one body for
    both kernel shapes (the JAX ``_make_conv_bn_op``)."""

    class ConvBNAct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w, gamma, beta, eps, relu, group):
            wc = w.to(a.dtype)
            y = conv2d_nhwc(a, wc, padding=ks // 2)
            o, mu, var, inv = bn_act_fwd(y, gamma, beta, eps, relu, group)
            ctx.save_for_backward(a, wc, y, mu, inv, gamma, beta)
            ctx.relu, ctx.group = relu, group
            ctx.w_dtype = w.dtype
            ctx.mark_non_differentiable(mu, var)
            return o, mu, var

        @staticmethod
        def backward(ctx, do, _dmu, _dvar):
            a, wc, y, mu, inv, gamma, beta = ctx.saved_tensors
            do = do.contiguous()
            s, t, u, v, dgamma, dbeta = bn_bwd_vectors(y, do, mu, inv, gamma, beta, ctx.relu,
                                                       ctx.group)
            da, dw = dgrad_wgrad(y, do, a, wc, s, t, u, v, ctx.relu)
            return (da.to(a.dtype), dw.to(ctx.w_dtype), dgamma.to(gamma.dtype),
                    dbeta.to(beta.dtype), None, None, None)

    ConvBNAct.__name__ = ConvBNAct.__qualname__ = f"ConvBNAct{ks}x{ks}"
    return ConvBNAct


_Conv1x1BNAct = _make_conv_bn_op(1, fused_dgrad_wgrad)
_Conv3x3BNAct = _make_conv_bn_op(3, fused_dgrad_wgrad_3x3)


def conv1x1_bn_act(a, w, gamma, beta, eps: float = 1e-5, relu: bool = False, group=None):
    """``(o, mu, var) = BN+ReLU(conv1x1(a, w))`` with the fused backward (K4).

    ``a``: NHWC activations; ``w``: [Co, Ci, 1, 1] f32, cast to ``a.dtype``
    for compute (its gradient comes back f32 from the kernel).  mu and var
    carry no gradient; the caller updates the running statistics with them.
    ``group``: BatchNorm over the global batch of its ranks.
    """
    return _Conv1x1BNAct.apply(a, w, gamma, beta, eps, relu, group)


def conv3x3_bn_act(a, w, gamma, beta, eps: float = 1e-5, relu: bool = False, group=None):
    """``(o, mu, var) = BN+ReLU(conv3x3_s1_SAME(a, w))`` with the fused
    backward (K5), the 3x3 counterpart of ``conv1x1_bn_act``."""
    return _Conv3x3BNAct.apply(a, w, gamma, beta, eps, relu, group)


def conv3x3_plane_fits_vmem(h: int, w_: int, ci: int, co: int, itemsize: int,
                            budget: int = 48 << 20) -> bool:
    """The JAX package's slot-selection rule for the 3x3 fold, kept as it is
    so that the port folds exactly the slots the JAX model folds (every
    ResNet-50 bf16 3x3 slot).  It estimates the TPU kernel's VMEM working
    set (whole planes, channels padded to 128 lanes, a 1.5x headroom) and is
    not K5's limit: K5 tiles planes and takes every width this rule folds
    (up to 2656 pixels at h = 1 and 64 channels)."""
    ci_p = ((ci + 127) // 128) * 128
    co_p = ((co + 127) // 128) * 128
    hw = (h + 2) * (w_ + 2)
    est = (hw * (12 * co_p + 8 * ci_p + 3 * itemsize * (ci_p + co_p))
           + 9 * ci_p * co_p * (itemsize + 4))
    return (est * 3) // 2 <= budget


def conv_bn(conv, bn, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """A conv -> ``FusedBatchNormAct`` pair (the JAX ``conv1x1_bn``): the
    fused op in training mode when ``fused`` and the slot allows it,
    otherwise the two modules as they are.  ``conv`` is the port's
    ``models.resnet.Conv2d`` (stride 1, ungrouped, 1x1 or 3x3); the running
    statistics (over ``bn.group``'s ranks) are updated either way.  The parameters are the modules'
    own, so toggling the fold changes no ``state_dict``."""
    ks = conv.kernel_size
    if ks not in (1, 3) or conv.stride != 1 or conv.groups != 1:
        raise ValueError(f"no fused backward for a {ks}x{ks} conv of stride "
                         f"{conv.stride}, {conv.groups} groups")
    xd = x.to(conv.dtype)
    if fused and ks == 3 and not conv3x3_plane_fits_vmem(
            xd.shape[1], xd.shape[2], xd.shape[-1], conv.out_channels,
            xd.element_size()):
        fused = False
    if not (fused and bn.training):
        return bn(conv(xd))
    op = conv3x3_bn_act if ks == 3 else conv1x1_bn_act
    o, mu, var = op(xd, conv.weight, bn.weight, bn.bias, bn.eps, bn.relu, bn.group)
    bn.update_stats(mu, var)
    return o
