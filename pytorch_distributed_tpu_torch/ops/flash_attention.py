"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``pytorch_distributed_tpu/ops/flash_attention.py``.

- Forward: the kernel K1 (``csrc/flash_attention_fwd.cu``) replaces the
  Pallas ``_fwd_kernel``: online softmax over kv tiles kept in shared
  memory, O and the logsumexp out, no [L, L] score matrix in device memory.
  ``flash_attention_reference`` is the same function in plain PyTorch: the
  kernel wrapper takes it for CPU tensors only, and the card holds the
  kernel against it.  It is also the port's one body of plain attention,
  where the JAX model runs plain XLA attention and no kernel:
  ``dense_attention`` for short prompts and the decode steps over the KV
  cache.
- Backward: K2 (dq) and K3 (dk, dv) in ``csrc/flash_attention_bwd.cu``
  replace the Pallas ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; their plain
  version ``flash_attention_bwd_reference`` ports ``_bwd_blockwise``.  On
  bf16 they run on the tensor cores and round p and ds to bf16 before the
  second products, where the plain version keeps them f32; on f32 they run
  on the CUDA cores in f32 throughout.
- ``flash_attention_fn`` is the differentiable entry point (the JAX
  ``custom_vjp``): a ``torch.autograd.Function`` whose forward is K1 and
  whose backward is K2 then K3.

Layout: q, k, v are [B, L, H, D] like the JAX package; lse is [B, H, L] f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 scores, mask at -1e30, softmax, lse = m + log l.

    q is [B, Lq, H, D] and k, v are [B, Lk, H, D]; under ``causal`` query i
    sits at position ``q_offset + i`` and sees the keys at positions up to
    its own (the decode path's view of a KV cache).  Returns ``(out [B, Lq,
    H, D] in q's dtype, lse [B, H, Lq] f32)``.
    """
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / D ** 0.5)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = (acc / safe_l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(safe_l)).squeeze(-1)


def _check_same(*ts: torch.Tensor) -> None:
    """Tensors of one [B, L, H, D] shape, dtype and device."""
    if not (ts[0].dim() == 4 and all(t.shape == ts[0].shape for t in ts)):
        raise ValueError("q, k, v (and out, dout) must share one [B, L, H, D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if not all(t.dtype == ts[0].dtype and t.device == ts[0].device for t in ts):
        raise ValueError("q, k, v (and out, dout) must share dtype and device")


def _check_kernel_inputs(name: str, *ts: torch.Tensor) -> None:
    """What the kernels take: CUDA tensors, f32 or bf16, D in {64, 128},
    unit stride on D, at most 65535 tiles of 64 rows."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dim 64 or 128, not {q.shape[-1]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash kernels need unit stride on the head dim")
    if (q.shape[1] + 63) // 64 > 65535:
        raise ValueError(f"sequence length {q.shape[1]} exceeds the kernels' grid")


def _strides(*ts: torch.Tensor):
    """The (b, l, h) element strides of each [B, L, H, D] tensor, in order."""
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


@functools.cache
def _kernel():
    """The kernel's C entry point, built, loaded and typed on first use."""
    fn = _build.load("flash_attention_fwd").ptd_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over [B, L, H, D]; returns ``(out, lse [B, H, L])``.

    CUDA tensors go through the Hopper kernel (f32 or bf16, D in {64, 128},
    unit stride on D; anything else raises).  CPU tensors take the plain
    version.  ``flash_attention.launches`` counts kernel launches.
    """
    _check_same(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_kernel_inputs("flash_attention", q, k, v)
    B, L, H, D = q.shape
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if L == 0:
        return out, lse
    strides = _strides(q, k, v)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, L, D, _KERNEL_DTYPES[q.dtype], int(causal),
            *strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def _bwd_blockwise(q, k, v, dout, lse, delta, causal: bool, block_k: int = 1024):
    """The backward's arithmetic in plain PyTorch, given delta [B, H, L]:
    per kv block of ``block_k`` keys, recompute s, p = exp(s - lse), dp and
    ds = p * (dp - delta) * scale in f32.  Returns f32 (dq, dk, dv)
    [B, L, H, D]."""
    L, D = q.shape[1], q.shape[-1]
    scale = 1.0 / D ** 0.5
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, dout))  # [B, H, L, D]
    pos = torch.arange(L, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(0, L, block_k):
        ks, vs = kf[:, :, j:j + block_k], vf[:, :, j:j + block_k]
        s = qf @ ks.transpose(-1, -2) * scale                      # [B, H, L, bk]
        if causal:
            kpos = pos[j:j + block_k]
            s = s.masked_fill(kpos[None, :] > pos[:, None], NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(p.transpose(-1, -2) @ gf)
        ds = p * (gf @ vs.transpose(-1, -2) - delta[..., None]) * scale
        dq += ds @ ks
        dks.append(ds.transpose(-1, -2) @ qf)
    return tuple(t.transpose(1, 2) for t in
                 (dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)))


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) [B, H, L] f32, from O as saved (its own dtype)."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, a port of the JAX ``_bwd_blockwise``:
    f32 recompute of p from the saved lse, blockwise over kv.  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    grads = _bwd_blockwise(q, k, v, dout, lse, _delta(out, dout), causal)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


@functools.cache
def _bwd_kernels():
    """The backward kernels' C entry points (K2, K3), built, loaded and
    typed on first use."""
    lib = _build.load("flash_attention_bwd")
    dq_fn, dkv_fn = lib.ptd_flash_attention_bwd_dq, lib.ptd_flash_attention_bwd_dkv
    for fn, n_ptr in ((dq_fn, 7), (dkv_fn, 8)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    return dq_fn, dkv_fn


def _bwd_launch(name: str, fn, q, k, v, dout, lse, delta, outs, causal: bool) -> None:
    B, L, H, D = q.shape
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
                 B, H, L, D, _KERNEL_DTYPES[q.dtype], int(causal),
                 *_strides(q, k, v, dout),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _check_16b_aligned(name: str, *ts: torch.Tensor) -> None:
    """The bf16 backward kernels copy 16 bytes at a time: every base pointer
    and every (b, l, h) stride must be a multiple of 16 bytes."""
    for t in ts:
        es = t.element_size()
        if t.data_ptr() % 16 or any(s * es % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: bf16 kernels need 16-byte aligned data and "
                             f"(b, l, h) strides, got strides {t.stride()} at element "
                             f"offset {t.storage_offset()}")


def _check_bwd_inputs(name, q, k, v, dout, lse, delta) -> None:
    _check_same(q, k, v, dout)
    B, L, H, _ = q.shape
    for t in (lse, delta):
        if t.shape != (B, H, L) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous [B, H, L] "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if q.device.type != "cpu":
        _check_kernel_inputs(name, q, k, v, dout)
        if q.dtype == torch.bfloat16:
            _check_16b_aligned(name, q, k, v, dout)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True
                           ) -> torch.Tensor:
    """dq [B, L, H, D] in q's dtype, from delta = rowsum(dO * O) [B, H, L].
    CUDA tensors launch K2; CPU tensors take the plain version.
    ``flash_attention_bwd_dq.launches`` counts kernel launches."""
    _check_bwd_inputs("flash_attention_bwd_dq", q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return _bwd_blockwise(q, k, v, dout, lse, delta, causal)[0].to(q.dtype)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.shape[1]:
        _bwd_launch("flash_attention_bwd_dq", _bwd_kernels()[0], q, k, v, dout,
                    lse, delta, (dq,), causal)
        flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, L, H, D] in k's and v's dtype, from delta as above.
    CUDA tensors launch K3; CPU tensors take the plain version.
    ``flash_attention_bwd_dkv.launches`` counts kernel launches."""
    _check_bwd_inputs("flash_attention_bwd_dkv", q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        _, dk, dv = _bwd_blockwise(q, k, v, dout, lse, delta, causal)
        return dk.to(k.dtype), dv.to(v.dtype)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.shape[1]:
        _bwd_launch("flash_attention_bwd_dkv", _bwd_kernels()[1], q, k, v, dout,
                    lse, delta, (dk, dv), causal)
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward: ``(dq, dk, dv)`` in the dtypes of q, k and v.

    delta = rowsum(dO * O) is computed here in plain PyTorch from the saved
    O, as the JAX ``_bwd_pallas`` does; then K2 (dq) and K3 (dk, dv) launch
    on CUDA tensors.  CPU tensors take the plain version.
    """
    _check_same(q, k, v, out, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, causal)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    delta = _delta(out, dout)
    lse = lse.contiguous()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal), None)


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention over [B, L, H, D], returning out (the
    JAX ``flash_attention`` custom_vjp): K1 forward, K2 and K3 backward on
    CUDA tensors, the plain versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal)[0]


ATTN_IMPLS = ("auto", "flash", "dense")


def pick_attention_impl(L: int, head_dim: int, device: torch.device,
                        attn_impl: str = "auto") -> str:
    """``attn_impl`` "flash" or "dense" is taken as it is.  The shared 'auto'
    policy: "flash" (the kernels) on the card at long, 1024-aligned L, for
    the head dims the kernels take; "dense" otherwise.  The length rule is
    the JAX package's, kept as it is until it is retuned for the H100."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if attn_impl != "auto":
        return attn_impl
    if (torch.device(device).type == "cuda" and head_dim in _KERNEL_HEAD_DIMS
            and L >= 4096 and L % 1024 == 0):
        return "flash"
    return "dense"
