"""The port's divergence guard (``ft/divergence.py``) and the LM step's
non-finite gate against the JAX package's, on the CPU.

- ``DivergenceGuard`` on one numpy-seeded flag sequence (device tensors on
  the port's side, ``jnp`` scalars on JAX's): the same decisions at every
  ``observe``, the same ``skipped``, ``rollbacks``, ``lr_scale`` and
  ``ft_event`` records (apart from their times); a bad knob raises the
  same error.
- ``StateKeeper`` restores parameters, BN buffers, momentum, the
  ``GradSync`` state and the step's counter bitwise.
- The LM step's gate on the JAX ``test_lm_step_nonfinite_flag_gates_update``
  set-up (vocab 32, width 32, 2 heads, 1 layer, zero tokens, lr 0.1), on
  the GSPMD twin and the explicit path: clean, flag 0 and the 3-LM-step
  row against the JAX step (metrics rtol 1e-5, weights atol 2e-5 rtol
  1e-4: summation order); with NaN in every parameter, flag 1 on both
  sides, and the port's parameters, momentum and int8 residual bitwise as
  they were, the step counter advanced.
- Checkpoints carry ``lr_scale`` across the packages both ways: a JAX file
  resumes the port's guard, the port's file the JAX trainer's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ft import divergence as jdiv
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.obs import metrics as jmetrics
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel.tp import replicated_like
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.ft import divergence
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.obs import flightrec, metrics
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax
from tests.test_torch_zoo import FAST_COMPILE, jitted_flax_init  # noqa: F401  (fixture)

LM = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=1)
# The JAX trainers' weights are copied into the port (or replaced), so their
# init may be compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(JaxLM(**LM).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16), jnp.int32))["params"])


def _drive(guard, flags, path, read):
    decisions = []
    for step, f in enumerate(flags):
        due = guard.observe(step, f)
        if due:
            guard.note_rollback(step, restored_step=max(0, step - 4))
        decisions.append(due)
    decisions.append(guard.drain())
    guard.obs.close()
    events = [{k: v for k, v in r.items() if k != "t"} for r in read(path) if "ft_event" in r]
    return (decisions, guard.skipped, guard.rollbacks, guard.lr_scale, guard.consecutive,
            events)


@pytest.mark.parametrize("knobs", [dict(rollback_k=2, check_every=3, lr_backoff=0.5),
                                   dict(rollback_k=1, check_every=1, lr_backoff=0.25),
                                   dict(rollback_k=3, check_every=0, lr_backoff=1.0)])
def test_guard_decides_and_logs_as_jax_does(tmp_path, knobs):
    flags = (np.random.default_rng(7).random(60) < 0.45).astype(np.float32)
    flags[20:27] = 1.0  # a streak long enough for every K
    port = _drive(divergence.DivergenceGuard(**knobs,
                                             obs=metrics.MetricsLogger(str(tmp_path / "p"))),
                  [torch.tensor(f) for f in flags], str(tmp_path / "p"), metrics.read_metrics)
    want = _drive(jdiv.DivergenceGuard(**knobs, obs=jmetrics.MetricsLogger(str(tmp_path / "j"))),
                  [jnp.float32(f) for f in flags], str(tmp_path / "j"), jmetrics.read_metrics)
    assert port == want
    assert port[2] >= 1 and port[3] == knobs["lr_backoff"] ** port[2]


@pytest.mark.parametrize("bad", [dict(rollback_k=0), dict(rollback_k=-2), dict(lr_backoff=0.0),
                                 dict(lr_backoff=1.5), dict(lr_backoff=-0.5)])
def test_guard_refuses_bad_knobs_in_jax_words(bad):
    with pytest.raises(ValueError) as want:
        jdiv.DivergenceGuard(**bad)
    with pytest.raises(ValueError) as got:
        divergence.DivergenceGuard(**bad)
    assert str(got.value) == str(want.value)


def test_guard_drains_in_one_transfer_per_cadence(monkeypatch):
    """Flags stay device tensors until the drain, which stacks them."""
    calls = []
    real = divergence._host_values
    monkeypatch.setattr(divergence, "_host_values", lambda f: calls.append(len(f)) or real(f))
    g = divergence.DivergenceGuard(rollback_k=5, check_every=4)
    for i in range(10):
        g.observe(i, torch.tensor(float(i % 3 == 0)))
    assert calls == [4, 4] and len(g._pending) == 2
    assert g.drain() is False and calls == [4, 4, 2] and g.skipped == [0, 3, 6, 9]


def _bits(tensors):
    return [t.detach().clone().view(torch.int32) if t.dtype == torch.float32 else t.clone()
            for t in tensors]


def test_state_keeper_restores_every_tensor_bitwise(params):
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    opt = sgd(model.parameters())
    step = lm.make_lm_train_step(model, opt, grad_compress="int8")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (8, 16)).astype(np.int32))
    keeper = divergence.StateKeeper()
    assert not keeper.has_snapshot
    with pytest.raises(RuntimeError, match="no snapshot"):
        keeper.restore(model, opt)
    keeper.update(model, opt, 0, comm=step.comm, step_fn=step)   # before any momentum
    step(toks, 0.1)
    first = _bits(divergence._state_tensors(model, opt, step.comm))
    keeper.update(model, opt, 1, comm=step.comm, step_fn=step)
    for lr in (0.1, 0.2):
        step(toks, lr)
    assert step.count == 3
    keeper.restore(model, opt, comm=step.comm, step_fn=step)
    assert keeper.step == 1 and step.count == 1
    for a, b in zip(_bits(divergence._state_tensors(model, opt, step.comm)), first):
        assert torch.equal(a, b)


def _jax_step(params, explicit, mode=None):
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    model = JaxLM(**LM)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    step = jax_lm.make_lm_train_step(model, mesh, replicated_like(p), guard_nonfinite=True,
                                     overlap="bucketed" if explicit else "none",
                                     grad_compress=mode, params=p)
    return mesh, step, TrainState.create({"params": p}, sgd_init(p))


@pytest.mark.parametrize("explicit", [False, True], ids=["gspmd", "explicit"])
def test_lm_step_gate_matches_jax(params, explicit):
    tokens = np.zeros((8, 16), np.int32)
    mesh, jstep, state = _jax_step(params, explicit)
    with mesh:
        jstep = jstep.lower(state, jnp.asarray(tokens), jnp.float32(0.1)).compile(FAST_COMPILE)
        clean, jm = jstep(state, jnp.asarray(tokens), jnp.float32(0.1))
        poisoned = TrainState.create({"params": jax.tree_util.tree_map(
            lambda p: jnp.asarray(p).at[(0,) * p.ndim].set(jnp.nan), params)},
            sgd_init(params))
        _, jbad = jstep(poisoned, jnp.asarray(tokens), jnp.float32(0.1))
    overlap = "bucketed" if explicit else "none"
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    opt = sgd(model.parameters())
    step = lm.make_lm_train_step(model, opt, guard_nonfinite=True, overlap=overlap)
    m = step(torch.from_numpy(tokens), 0.1)
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = lm_state_dict_from_jax(jax.device_get(clean.params))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    # Poisoned, with momentum and an int8 residual that are not zero: the
    # update passes through bitwise, the counter advances.
    model.load_state_dict(lm_state_dict_from_jax(params))
    opt = sgd(model.parameters())
    step = lm.make_lm_train_step(model, opt, guard_nonfinite=True, overlap=overlap,
                                 grad_compress="int8")
    step(torch.from_numpy(np.random.default_rng(2).integers(0, 32, (8, 16)).astype(np.int32)),
         0.1)
    with torch.no_grad():
        for p in model.parameters():
            p.view(-1)[0] = float("nan")
    before = _bits(divergence._state_tensors(model, opt, step.comm))
    assert any(t.abs().sum() > 0 for t in step.comm.state_tensors())
    m = step(torch.from_numpy(tokens), 0.1)
    assert float(m["nonfinite"]) == float(jbad["nonfinite"]) == 1.0
    assert step.count == 2
    for a, b in zip(_bits(divergence._state_tensors(model, opt, step.comm)), before):
        assert torch.equal(a, b)


def test_checkpoints_carry_lr_scale_across_packages(tmp_path, params):
    ds = lm.SyntheticTokenDataset(16, 16, 32, seed=0)
    jstate = TrainState.create({"params": params}, sgd_init(params))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 0, "transformer_lm", 0.0,
                             is_best=False, ft={"step": 3, "global_step": 3, "lr_scale": 0.5})
    model = TransformerLM(**LM, device="cpu")
    t = lm.LMTrainer(model, ds, 4, nan_guard=True, prefetch=0,
                     resume=str(tmp_path / "jax" / ckpt.CHECKPOINT_NAME))
    assert t.ft_guard.lr_scale == 0.5 and t._start_step == 3
    t.ft_guard.lr_scale = 0.25
    t.checkpoint_dir = str(tmp_path / "port")
    t.fit(4, print_freq=100)
    _, meta = jax_ckpt.load_checkpoint(str(tmp_path / "port" / ckpt.CHECKPOINT_NAME), jstate)
    assert meta["ft"]["lr_scale"] == 0.25 and meta["ft"]["step"] == 4
    # ... and the JAX trainer resumes its guard from the port's file.
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    jt = jax_lm.LMTrainer(JaxLM(**LM, dtype=jnp.float32), mesh,
                          jax_lm.SyntheticTokenDataset(16, 16, 32), 4, nan_guard=True,
                          prefetch=0, resume=str(tmp_path / "port" / ckpt.CHECKPOINT_NAME))
    assert jt.ft_guard.lr_scale == 0.25 and jt._start_step == 4
    # Without the guard the record holds 1.0, as the JAX trainer writes.
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    t = lm.LMTrainer(model, ds, 4, prefetch=0, checkpoint_dir=str(tmp_path / "plain"))
    t.fit(1, print_freq=100)
    _, meta = jax_ckpt.load_checkpoint(str(tmp_path / "plain" / ckpt.CHECKPOINT_NAME), jstate)
    assert meta["ft"]["lr_scale"] == 1.0


def _badput_in_steps(records, goodput):
    """``compute_goodput`` with every step record timed 1 s: the badput in
    steps, equal across packages whose wall clocks differ."""
    rep = goodput.compute_goodput([dict(r, step_time=1.0) if "ft_event" not in r else r
                                   for r in records])
    return rep.counts, rep.badput_s


@pytest.mark.parametrize("save_steps", [0, 2])
def test_lm_rollback_recovers_as_the_jax_trainer_does(tmp_path, params, save_steps):
    """JAX ``tests/test_ft.py::test_lm_divergence_rollback_recovers_training``
    (``LRSpikeAt(2, 1e30)``, K 2, check every 3, 16 steps) on both trainers
    from the same weights, without and with a snapshot every 2 steps: the
    same skipped steps, rollbacks, restored step and LR scale, the same
    ``ft_event`` records (times aside) and badput, and the port dumps its
    flight ring as ``rollback``; losses and final weights
    within the 3-LM-step row (f32: the runs differ only in summation order,
    and the rollback restores weights both sides hold bitwise)."""
    from pytorch_distributed_tpu.ft import chaos as jchaos
    from pytorch_distributed_tpu.obs import goodput as jgoodput
    from pytorch_distributed_tpu_torch.ft import chaos
    from pytorch_distributed_tpu_torch.obs import goodput

    kw = dict(nan_guard=True, ft_rollback_k=2, ft_check_every=3, save_steps=save_steps,
              prefetch=0)
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    with mesh:
        jt = jax_lm.LMTrainer(JaxLM(**LM, dtype=jnp.float32), mesh,
                              jax_lm.SyntheticTokenDataset(64, 16, 32), 8, lr=0.05, seed=0,
                              metrics_jsonl=str(tmp_path / "jax.jsonl"),
                              chaos=jchaos.ChaosSchedule(jchaos.LRSpikeAt(2, 1e30)), **kw)
        jt.state = jt.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
        jfinal = jt.fit(16, print_freq=8)
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    t = lm.LMTrainer(model, lm.SyntheticTokenDataset(64, 16, 32), 8, lr=0.05,
                     metrics_jsonl=str(tmp_path / "port.jsonl"), flight_rec=str(tmp_path / "fr"),
                     hang_timeout=300.0, chaos=chaos.ChaosSchedule(chaos.LRSpikeAt(2, 1e30)),
                     **kw)
    final = t.fit(16, print_freq=8)
    dump = json.loads(open(flightrec.dump_path(str(tmp_path / "fr"), 0)).read())
    assert dump["reason"] == "rollback"
    g, j = t.ft_guard, jt.ft_guard
    assert (g.skipped, g.rollbacks, g.lr_scale, g.consecutive) == \
        (j.skipped, j.rollbacks, j.lr_scale, j.consecutive)
    assert g.rollbacks >= 1 and g.lr_scale < 1.0 and g.skipped
    assert t._keeper.step == jt._keeper.step
    got, want = metrics.read_metrics(str(tmp_path / "port.jsonl")), \
        jmetrics.read_metrics(str(tmp_path / "jax.jsonl"))
    events = [[{k: v for k, v in r.items() if k != "t"} for r in recs if "ft_event" in r]
              for recs in (got, want)]
    assert events[0] == events[1] and {"skip", "rollback"} <= {e["ft_event"] for e in events[0]}
    steps = [[r for r in recs if "ft_event" not in r] for recs in (got, want)]
    assert [r["step"] for r in steps[0]] == [r["step"] for r in steps[1]] == list(range(16))
    assert [r["nonfinite"] for r in steps[0]] == [r["nonfinite"] for r in steps[1]]
    restored = max(e["step"] for e in events[0] if e["ft_event"] == "rollback")
    np.testing.assert_allclose([r["loss"] for r in steps[0][restored + 1:]],
                               [r["loss"] for r in steps[1][restored + 1:]], rtol=1e-5)
    assert np.isfinite(final) and np.isfinite(jfinal)
    np.testing.assert_allclose(final, jfinal, rtol=1e-5)
    wantw = lm_state_dict_from_jax(jax.device_get(jt.state.params))
    for name, w in model.state_dict().items():
        assert torch.isfinite(w).all()
        np.testing.assert_allclose(w.numpy(), wantw[name].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    counts, badput = _badput_in_steps(got, goodput)
    assert (counts, badput) == _badput_in_steps(want, jgoodput)
    assert counts["nan_skip"] == len(g.skipped) and counts["rollback_discard"] == g.rollbacks
    # Restored to step 0, the clean steps 1-2 are discarded; restored to
    # step 2, every discarded step was already a skip.
    assert badput["nan_skip"] > 0 and (badput["rollback_discard"] > 0) == (save_steps == 0)
