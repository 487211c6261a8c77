"""Port's fused BatchNorm(+ReLU) vs the JAX package's ``ops/fused_bn.py``.

Inputs are numpy-seeded and fed to both sides in NHWC.  Tolerances:

- f32: forward, statistics and the three gradients agree to 1e-5 (abs and
  rel): the same one-pass f32 moments and backward formula, reduced in
  another order;
- bf16 input (f32 statistics and parameters): the output and dx are
  rounded to bf16 on both sides, and a value whose f32 pre-image sits near
  a rounding boundary may land one bf16 ulp (2^-8 relative) apart: atol =
  rtol = 1e-2; the f32 statistics and dgamma/dbeta stay at 1e-4, since
  they reduce the same bf16 inputs in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.fused_bn import FusedBatchNormAct as JaxBN
from pytorch_distributed_tpu.ops.fused_bn import _bn_act as jax_bn_act
from pytorch_distributed_tpu_torch.ops.fused_bn import FusedBatchNormAct, bn_act

EPS = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-4)}


def _inputs(seed, shape=(3, 5, 4, 8)):
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    gamma = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    beta = (rng.normal(size=c) * 0.3).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    return y, gamma, beta, cot


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bn_act_forward_backward_match_jax(dt, relu):
    tdt, jdt, tol, stat_tol = DTYPES[dt]
    y, gamma, beta, cot = _inputs(1)
    jy = jnp.asarray(y, jdt)
    (jo, jmu, jvar), vjp = jax.vjp(
        lambda y_, g, b: jax_bn_act(y_, g, b, EPS, relu), jy, gamma, beta)
    jdy, jdg, jdb = vjp((jnp.asarray(cot, jdt), jnp.zeros_like(jmu), jnp.zeros_like(jvar)))

    ty = torch.tensor(np.asarray(jy.astype(jnp.float32))).to(tdt).requires_grad_()
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    o, mu, var = bn_act(ty, tg, tb, EPS, relu)
    assert o.dtype == tdt and mu.dtype == var.dtype == torch.float32
    o.backward(torch.tensor(cot).to(tdt))
    _close(o, jo.astype(jnp.float32), tol, "o")
    _close(mu, jmu, stat_tol, "mu")
    _close(var, jvar, stat_tol, "var")
    _close(ty.grad, jdy.astype(jnp.float32), tol, "dy")
    _close(tg.grad, jdg, stat_tol * 10, "dgamma")
    _close(tb.grad, jdb, stat_tol * 10, "dbeta")


@pytest.mark.parametrize("relu", [True, False])
def test_module_ema_and_eval_match_jax(relu):
    """Two training-mode calls update the running statistics by the JAX EMA
    (0.9 old + 0.1 batch, biased variance); the eval-mode output then uses
    them.  f32, 1e-5."""
    y1, gamma, beta, _ = _inputs(2)
    y2 = _inputs(3)[0] * 0.5 - 1.0
    jm = JaxBN(relu=relu)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(y1), use_running_average=True)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    stats = variables["batch_stats"]
    for y in (y1, y2):
        _, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(y),
                          use_running_average=False, mutable=["batch_stats"])
        stats = mut["batch_stats"]
    jeval = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(y1),
                     use_running_average=True)

    tm = FusedBatchNormAct(8, relu=relu, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(gamma))
        tm.bias.copy_(torch.tensor(beta))
    for y in (y1, y2):
        tm(torch.tensor(y))
    _close(tm.running_mean, stats["mean"], 1e-5, "running_mean")
    _close(tm.running_var, stats["var"], 1e-5, "running_var")
    _close(tm.eval()(torch.tensor(y1)), jeval, 1e-5, "eval output")


def test_sync_bn_group_of_one_matches_the_jax_axis_name(monkeypatch):
    """``--sync-bn``'s BatchNorm: over a gloo group of one rank the port's
    ``bn_act(group=...)`` equals the JAX ``_bn_act(axis_name=...)`` over a
    mapped axis of one (f32, 1e-5), and the port without a group bitwise:
    every all-reduce of one rank is a copy."""
    import socket

    from pytorch_distributed_tpu_torch.parallel import initialize, shutdown

    y, gamma, beta, cot = _inputs(4)

    def rank(y_, cot_):
        (o, mu, var), vjp = jax.vjp(
            lambda a, g, b: jax_bn_act(a, g, b, EPS, True, axis_name="data"), y_, gamma, beta)
        return (o, mu, var) + vjp((cot_, jnp.zeros_like(mu), jnp.zeros_like(var)))

    want = [x[0] for x in jax.vmap(rank, axis_name="data")(jnp.asarray(y)[None],
                                                           jnp.asarray(cot)[None])]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES="1",
                     PTD_TPU_PROCESS_ID="0").items():
        monkeypatch.setenv(k, v)
    ctx = initialize(device="cpu")
    try:
        runs = []
        for group in (ctx.group, None):
            leaves = [torch.tensor(x, requires_grad=True) for x in (y, gamma, beta)]
            o, mu, var = bn_act(*leaves, EPS, True, group=group)
            o.backward(torch.tensor(cot))
            runs.append([o, mu, var] + [t.grad for t in leaves])
    finally:
        shutdown(ctx)
    synced, local = runs
    for a, b in zip(synced, local):
        assert torch.equal(a, b)
    for got, w, name in zip(synced, want, ("o", "mu", "var", "dy", "dgamma", "dbeta")):
        _close(got, w, 1e-5 if name in ("o", "mu", "var", "dy") else 1e-4, name)
