"""BatchNorm(+ReLU) with a hand-written backward, the port of
``pytorch_distributed_tpu/ops/fused_bn.py``.

- Forward: one-pass batch statistics (mean and mean of squares, f32
  accumulation over inputs of any dtype, the variance clamped at >= 0), then
  ``o = (y * scale + shift)`` in f32, cast back to the input's dtype, and an
  optional ReLU.
- Backward (``_BNAct``, a ``torch.autograd.Function``): saves only the
  pre-BN tensor and per-channel vectors; the ReLU mask is recomputed from
  them (``gamma * xhat + beta > 0``).
- ``FusedBatchNormAct``: the module, with torchvision's parameter and buffer
  names (``weight``, ``bias``, ``running_mean``, ``running_var``).  Its
  running statistics follow the JAX EMA, ``0.9 * old + 0.1 * var`` with the
  *biased* one-pass variance.  ``nn.BatchNorm2d`` / ``F.batch_norm`` in
  training mode are not used: they write the unbiased variance.

Layout: channels last, ``[..., C]``, as in the JAX package; statistics
reduce over every other axis.

``group`` (a ``torch.distributed`` process group) gives the statistics of
the batch all ranks hold together, the JAX step's global-batch BatchNorm
under GSPMD: the forward averages the one-pass moments over equal shards
(the JAX ``axis_name`` path's ``pmean``, ``:52-54``) and the backward sums
dbeta, dgamma and the element count over the ranks before forming dx
(``:108-111``); the returned dgamma and dbeta stay this rank's sums, for the
step's gradient all-reduce.  The same group gives ``--sync-bn`` (the JAX
``axis_name`` under explicit collectives): the explicit step sets it too.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn


def _axes(y: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(y.dim() - 1))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks (in place; ``t`` itself without a
    group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def global_sums(dbeta: torch.Tensor, dgamma: torch.Tensor, n: int, group):
    """``(dbeta, dgamma, n)`` of the global batch for the through-stats
    terms of the BN backward: the per-channel sums and the element count
    summed over ``group``'s equal shards (unchanged without a group)."""
    if group is None:
        return dbeta, dgamma, n
    dbeta_g, dgamma_g = all_reduce_sum(torch.stack([dbeta, dgamma]), group)
    return dbeta_g, dgamma_g, n * dist.get_world_size(group)


def _stats(y: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass batch mean and variance over all but the channel axis, f32;
    under ``group`` the moments are averaged over its ranks' equal shards."""
    axes = _axes(y)
    yf = y.float()
    mu = yf.mean(axes)
    ms = (yf * yf).mean(axes)
    if group is not None:
        moments = all_reduce_sum(torch.stack([mu, ms]), group)
        mu, ms = moments / dist.get_world_size(group)
    # One-pass E[y^2] - mu^2 can go (numerically) negative under
    # cancellation; clamp it as the JAX package does.
    return mu, (ms - mu * mu).clamp_min(0.0)


def bn_act_fwd(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
               relu: bool, group=None):
    """``(o, mu, var, inv)``: the normalised (and rectified) output in y's
    dtype, the batch statistics (over ``group``'s ranks) and ``inv =
    rsqrt(var + eps)``."""
    mu, var = _stats(y, group)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    shift = beta - mu * scale
    o = (y.float() * scale + shift).to(y.dtype)
    if relu:
        o = torch.relu(o)
    return o, mu, var, inv


def bn_act_bwd(y, do, mu, inv, gamma, beta, relu: bool, group=None):
    """``(dx, dgamma, dbeta)`` of ``bn_act_fwd``'s output cotangent ``do``,
    through the batch statistics, in the dtypes of y, gamma and beta; under
    ``group`` the through-stats terms use the sums over its ranks, while
    dgamma and dbeta come back as this rank's sums."""
    axes = _axes(y)
    n = y.numel() // y.shape[-1]
    yf = y.float()
    xhat = (yf - mu) * inv
    dof = do.float()
    if relu:
        dof = torch.where(gamma * xhat + beta > 0, dof, 0.0)
    dbeta = dof.sum(axes)
    dgamma = (dof * xhat).sum(axes)
    dbeta_g, dgamma_g, n_g = global_sums(dbeta, dgamma, n, group)
    dx = (gamma * inv) * (dof - dbeta_g / n_g - xhat * (dgamma_g / n_g))
    return dx.to(y.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


class _BNAct(torch.autograd.Function):
    """``(o, mu, var)`` forward; the backward reads the saved pre-BN tensor
    and per-channel vectors only.  mu and var carry no gradient (the EMA
    update takes them outside the graph)."""

    @staticmethod
    def forward(ctx, y, gamma, beta, eps, relu, group):
        o, mu, var, inv = bn_act_fwd(y, gamma, beta, eps, relu, group)
        ctx.save_for_backward(y, mu, inv, gamma, beta)
        ctx.relu, ctx.group = relu, group
        ctx.mark_non_differentiable(mu, var)
        return o, mu, var

    @staticmethod
    def backward(ctx, do, _dmu, _dvar):
        y, mu, inv, gamma, beta = ctx.saved_tensors
        return (*bn_act_bwd(y, do, mu, inv, gamma, beta, ctx.relu, ctx.group), None, None,
                None)


def bn_act(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
           relu: bool = False, group=None):
    """``(o, mean, var)`` of the batch-normalised ``y [..., C]`` (+ReLU), the
    JAX ``_bn_act``; ``group``: statistics over the ranks' global batch (the
    JAX ``axis_name``)."""
    return _BNAct.apply(y, gamma, beta, eps, relu, group)


class FusedBatchNormAct(nn.Module):
    """BatchNorm (+ optional ReLU) over ``[..., C]`` with the JAX module's
    semantics: f32 parameters and statistics, the input's dtype for storage,
    batch statistics in training mode (and the EMA ``momentum * old + (1 -
    momentum) * new``, momentum 0.9), running statistics in eval mode.
    ``zero_init`` starts the scale at 0 (a residual block's last BN).
    ``group``: the process group whose ranks' batches the training-mode
    statistics cover (None: this rank's batch); set by the train step, not
    part of the ``state_dict``."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 relu: bool = False, zero_init: bool = False, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.relu = relu
        self.zero_init = zero_init
        self.group = None
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.full((features,), 0.0 if zero_init else 1.0, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    @torch.no_grad()
    def update_stats(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        """The JAX EMA: ``m * old + (1 - m) * batch`` (biased variance)."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def eval_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise with the running statistics (eval mode)."""
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = self.weight * inv
        shift = self.bias - self.running_mean * scale
        o = (x.float() * scale + shift).to(x.dtype)
        return torch.relu(o) if self.relu else o

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self.eval_forward(x)
        o, mu, var = bn_act(x, self.weight, self.bias, self.eps, self.relu, group=self.group)
        self.update_stats(mu, var)
        return o
