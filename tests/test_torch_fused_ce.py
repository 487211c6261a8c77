"""The port's fused tied-head cross-entropy (``ops/fused_ce.py``) and its LM
loss path against the JAX package, on the CPU.

- ``fused_ce_sums`` and its dh, dE and dw against JAX ``fused_ce_sums``
  (f32 at ragged N = 37 with 1, 3 and 8 chunks, so the weight-0 padding
  runs; and bf16 operands): loss rtol 1e-6, gradients atol 1e-5 of their
  largest (f32: the same f32 softmax, the products summed in another
  order); bf16 loss rtol 1e-5 and gradients 2e-2 of their largest (dh is
  rounded to bf16 on both sides: one bf16 ulp is 2**-8 relative).
  correct_sum exactly.
- fused against the port's unfused head (``cross_entropy`` of the logits),
  f32, the same tolerances (correct_sum rtol 1e-6: the chunks add the
  weighted hits in another order).
- 3 LM SGD steps with ``fused_ce_chunks=4`` and ``accum_steps=2`` against
  JAX ``make_lm_train_step(fused_ce_chunks=4)`` on a one-device mesh (auto
  = replicated there): PERF.md's 3-LM-step tolerances, metrics rtol 1e-5,
  weights atol 2e-5, rtol 1e-4.
- ``resolve_fused_ce_mode`` at one device: auto and replicated give
  replicated, dp and tp raise the JAX errors, as the JAX function does on
  a one-device mesh.
- ``lm_pretrain --fused-ce 4`` runs; with ``--pp`` it gets the JAX refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.ops import fused_ce as jfce
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel.tp import replicated_like, shard_state
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_ce_sums, resolve_fused_ce_mode
from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

N, D, V = 37, 16, 50
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
LRS = (0.05, 0.04, 0.03)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    """h, e, targets (a quarter set to the argmax, so correct_sum counts),
    weights; numpy."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    e = rng.normal(size=(V, D)).astype(np.float32)
    t = rng.integers(0, V, size=N).astype(np.int32)
    hits = rng.random(N) < 0.25
    t[hits] = np.argmax(h @ e.T, axis=-1)[hits]
    w = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    return h, e, t, w


def _jax_sums_and_grads(h, e, t, w, chunks, dtype):
    def loss(h, e, w):
        return jfce.fused_ce_sums(h.astype(dtype), e.astype(dtype), t, w, chunks)[0]

    args = (jnp.asarray(h), jnp.asarray(e), jnp.asarray(w))
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    _, correct = jfce.fused_ce_sums(args[0].astype(dtype), args[1].astype(dtype),
                                    jnp.asarray(t), args[2], chunks)
    return float(val), float(correct), [np.asarray(g, np.float32) for g in grads]


def _port_sums_and_grads(h, e, t, w, chunks, dtype):
    leaves = [torch.tensor(x, requires_grad=True) for x in (h, e, w)]
    th, te, tw = leaves
    loss, correct = fused_ce_sums(th.to(dtype), te.to(dtype), torch.from_numpy(t), tw, chunks)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), float(correct), [g.float().numpy() for g in grads]


def _close_grads(got, want, rel):
    for name, g, w in zip(("dh", "dE", "dw"), got, want):
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("chunks", [1, 3, 8])
def test_fused_ce_sums_match_jax_f32(chunks):
    h, e, t, w = _inputs()
    jl, jc, jg = _jax_sums_and_grads(h, e, t, w, chunks, jnp.float32)
    pl, pc, pg = _port_sums_and_grads(h, e, t, w, chunks, torch.float32)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    assert pc == jc > 0
    _close_grads(pg, jg, 1e-5)


def test_fused_ce_sums_match_jax_bf16():
    h, e, t, w = _inputs(seed=1)
    jl, jc, jg = _jax_sums_and_grads(h, e, t, w, 3, jnp.bfloat16)
    pl, pc, pg = _port_sums_and_grads(h, e, t, w, 3, torch.bfloat16)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pc == jc
    _close_grads(pg, jg, 2e-2)


def test_fused_matches_the_unfused_head():
    h, e, t, w = _inputs(seed=2)
    pl, pc, pg = _port_sums_and_grads(h, e, t, w, 3, torch.float32)
    leaves = [torch.tensor(x, requires_grad=True) for x in (h, e, w)]
    logits = leaves[0] @ leaves[1].T
    tt = torch.from_numpy(t).long()
    per_row = cross_entropy(logits, tt, weights=leaves[2]) * leaves[2].sum()
    grads = torch.autograd.grad(per_row, leaves)
    np.testing.assert_allclose(pl, float(per_row.detach()), rtol=1e-6)
    # The chunked weighted sum adds the hits in another order.
    np.testing.assert_allclose(
        pc, float(((logits.argmax(-1) == tt).float() * leaves[2].detach()).sum()), rtol=1e-6)
    _close_grads(pg, [g.numpy() for g in grads], 1e-5)


def test_correct_sum_carries_no_gradient():
    h, e, t, w = _inputs()
    th = torch.tensor(h, requires_grad=True)
    _, correct = fused_ce_sums(th, torch.from_numpy(e), torch.from_numpy(t),
                               torch.from_numpy(w), 2)
    assert not correct.requires_grad


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def test_lm_steps_with_fused_ce_match_jax(params):
    """3 SGD steps, ``fused_ce_chunks=4`` and ``accum_steps=2``, f32, from
    the same weights on the same tokens: each step's loss and accuracy and
    every weight after the last."""
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 64, size=(8, 32)).astype(np.int32) for _ in LRS]
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    specs = replicated_like(params)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = shard_state(TrainState.create({"params": p}, sgd_init(p)), specs, mesh)
    jstep = jax_lm.make_lm_train_step(JaxLM(**CFG), mesh, specs, accum_steps=2,
                                      fused_ce_chunks=4)
    want = []
    with mesh:
        for toks, rate in zip(batches, LRS):
            toks = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("data", None)))
            state, m = jstep(state, toks, jnp.float32(rate))
            want.append([float(m[k]) for k in sorted(m)])
    model = TransformerLM(**CFG, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    step = lm.make_lm_train_step(model, sgd(model.parameters()), accum_steps=2,
                                 fused_ce_chunks=4)
    got = []
    for toks, rate in zip(batches, LRS):
        m = step(torch.from_numpy(toks), rate)
        got.append([float(m[k]) for k in sorted(m)])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = lm_state_dict_from_jax(jax.device_get(state.params))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_fused_ce_mode_rules_at_one_device():
    assert resolve_fused_ce_mode("auto", 64) == resolve_fused_ce_mode("replicated") == "replicated"
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    specs = {"embed": {"embedding": P()}}
    assert jax_lm.resolve_fused_ce_mode("auto", specs, mesh, 64) == ("replicated", None)
    for mode in ("dp", "tp"):
        with pytest.raises(ValueError) as want:
            jax_lm.resolve_fused_ce_mode(mode, specs, mesh, 64)
        prefix = str(want.value).split("; got")[0]
        with pytest.raises(ValueError) as got:
            resolve_fused_ce_mode(mode, 64)
        assert str(got.value).startswith(prefix)
    with pytest.raises(ValueError, match="auto|replicated|dp|tp"):
        resolve_fused_ce_mode("zigzag")
    model = TransformerLM(**CFG, device="cpu")
    with pytest.raises(ValueError, match="fused_ce_mode='dp'"):
        lm.make_lm_train_step(model, sgd(model.parameters()), fused_ce_chunks=2,
                              fused_ce_mode="dp")


TINY = ["--device", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
        "--n-layers", "1", "--seq-len", "32", "-b", "4", "--steps", "2", "-p", "1",
        "--eval-batches", "1"]


def test_lm_pretrain_fused_ce_runs_and_matches_unfused_f32(capsys):
    """``--fused-ce 4`` through the recipe, f32: the same losses as the
    unfused run to the loss tolerance."""
    fused = lm_pretrain.run(TINY + ["--precision", "fp32", "--fused-ce", "4"])
    plain = lm_pretrain.run(TINY + ["--precision", "fp32"])
    np.testing.assert_allclose([float(x) for x in fused.losses],
                               [float(x) for x in plain.losses], rtol=1e-5)
    assert "Final loss" in capsys.readouterr().out


def test_lm_pretrain_fused_ce_with_pp_gets_the_jax_refusal():
    with pytest.raises(SystemExit, match="--fused-ce applies to the non-pipelined loss path"):
        lm_pretrain.main(TINY + ["--fused-ce", "4", "--pp", "2"])
