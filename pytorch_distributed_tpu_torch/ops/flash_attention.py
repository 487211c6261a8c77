"""Flash attention forward: a hand-written Hopper kernel and its plain version.

Port of ``pytorch_distributed_tpu/ops/flash_attention.py``'s forward.  The
kernel (``csrc/flash_attention_fwd.cu``) replaces the Pallas ``_fwd_kernel``:
online softmax over kv tiles kept in shared memory, O and the logsumexp out,
no [L, L] score matrix in device memory.  ``flash_attention_reference`` is
the same function in plain PyTorch: the kernel wrapper takes it for CPU
tensors only, and the card holds the kernel against it.  It is also the
port's one body of plain attention, where the JAX model runs plain XLA
attention and no kernel: ``dense_attention`` for short prompts and the
decode steps over the KV cache.

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
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, L, H, D = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim 64 or 128, not {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs unit stride on the head dim")
    if (L + 63) // 64 > 65535:
        raise ValueError(f"sequence length {L} exceeds the kernel's grid")
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if L == 0:
        return out, lse
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
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


def pick_attention_impl(L: int, head_dim: int, device: torch.device) -> str:
    """The shared 'auto' policy: "flash" (the kernel) on the card at long,
    1024-aligned L, for the head dims the kernel takes; "dense" otherwise.
    The length rule is the JAX package's, kept as it is until it is retuned
    for the H100."""
    if (torch.device(device).type == "cuda" and head_dim in _KERNEL_HEAD_DIMS
            and L >= 4096 and L % 1024 == 0):
        return "flash"
    return "dense"
