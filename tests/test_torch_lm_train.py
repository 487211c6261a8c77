"""Port's LM training path vs the JAX package on the same weights and tokens.

Weights cross through ``lm_state_dict_from_jax``; tokens and learning rates
are numpy-seeded and fed to both sides.  The JAX step runs on the 8-device
CPU data mesh with replicated parameters (``tests/test_lm_eval.py``'s
set-up), so the batch is a multiple of 8.  Tolerances:

- f32 losses and accuracies of each step rtol 1e-5 (the forward agrees to
  ~1e-6 relative; accuracy is a count of argmax hits, identical unless a
  logit pair ties to 1e-6); parameters after 3 SGD steps atol 2e-5,
  rtol 1e-4 (gradients differ by summation order, ~1e-6 relative, and
  three steps of lr 0.05 with momentum 0.9 carry that into the weights);
- the bf16 case (f32 parameters, bf16 compute) compares the losses at rtol
  2e-2: activations are rounded to bf16 at other points in the two
  frameworks and one bf16 ulp is 2^-8 relative, so per-step differences
  of a few ulp in the loss are expected; the weights then drift apart by
  bf16 gradient noise and are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.ops.loss import cross_entropy as jax_cross_entropy
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel.tp import replicated_like, shard_state
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.optim import sgd_init, sgd_update
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.models import transformer
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention_fn
from pytorch_distributed_tpu_torch.ops.loss import cross_entropy
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2)
LRS = (0.05, 0.04, 0.03)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops only: under the parallel suite, intra-op threads contend for
    the cores, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshSpec(("data",), (8,)), jax.devices()[:8])


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _tokens(seq, seed, batch=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=(batch, seq)).astype(np.int32) for _ in LRS]


def _port_model(params, dtype=torch.float32, attn_impl="auto"):
    model = TransformerLM(**CFG, dtype=dtype, param_dtype=torch.float32,
                          device="cpu", attn_impl=attn_impl)
    model.load_state_dict(lm_state_dict_from_jax(params))
    return model


def _jax_steps(params, mesh, batches, jdt, attn_impl, **kw):
    model = JaxLM(**CFG, dtype=jdt, attn_impl=attn_impl)
    specs = replicated_like(params)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = shard_state(TrainState.create({"params": p}, sgd_init(p)), specs, mesh)
    step = jax_lm.make_lm_train_step(model, mesh, specs, **kw)
    metrics = []
    with mesh:
        for toks, lr in zip(batches, LRS):
            toks = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("data", None)))
            state, m = step(state, toks, jnp.float32(lr))
            metrics.append([float(m[k]) for k in sorted(m)])
    return metrics, jax.device_get(state.params)


def _port_steps(params, batches, dtype, attn_impl, **kw):
    model = _port_model(params, dtype, attn_impl)
    step = lm.make_lm_train_step(model, sgd(model.parameters()), **kw)
    metrics = []
    for toks, lr in zip(batches, LRS):
        m = step(torch.from_numpy(toks), lr)
        metrics.append([float(m[k]) for k in sorted(m)])
    return metrics, model


@pytest.mark.parametrize("case", [
    dict(seq=32, attn_impl="auto"),
    dict(seq=32, attn_impl="auto", clip_grad_norm=0.5, log_norms=True),
    dict(seq=32, attn_impl="auto", accum_steps=2),
    dict(seq=128, attn_impl="flash"),
], ids=["plain", "clip", "accum2", "flash_pallas"])
def test_train_steps_match_jax(params, mesh, case):
    """3 SGD steps from the same weights: the metrics of each step (loss,
    accuracy; grad and param norms under ``log_norms``) and every parameter
    after the last.  ``flash_pallas`` runs the JAX
    Pallas forward and backward in interpret mode inside the step and the
    port's autograd Function on the CPU."""
    case = dict(case)
    seq, attn_impl = case.pop("seq"), case.pop("attn_impl")
    batches = _tokens(seq, seed=seq + len(case))
    want, want_params = _jax_steps(params, mesh, batches, jnp.float32, attn_impl, **case)
    got, model = _port_steps(params, batches, torch.float32, attn_impl, **case)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    sd = model.state_dict()
    for name, w in lm_state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=name)


def test_train_steps_bf16_compute_matches_jax_loss(params, mesh):
    batches = _tokens(32, seed=7)
    want, _ = _jax_steps(params, mesh, batches, jnp.bfloat16, "auto")
    got, model = _port_steps(params, batches, torch.bfloat16, "auto")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # sorted metric keys: acc, loss
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=2e-2)


def test_flash_path_carries_attention_gradient(params, monkeypatch):
    """The no-cache forward with attn_impl="flash" runs attention through
    the autograd Function, whose gradient reaches the qkv weights and
    equals the dense path's (the same f32 arithmetic; 1e-5)."""
    outs = []

    def spy(*args):
        outs.append(flash_attention_fn(*args))
        return outs[-1]

    monkeypatch.setattr(transformer, "flash_attention_fn", spy)
    tokens = torch.from_numpy(_tokens(64, seed=3)[0])
    grads = {}
    for impl in ("flash", "dense"):
        model = _port_model(params, attn_impl=impl)
        lm.lm_loss(model, tokens)[0].backward()
        grads[impl] = [b.attn.qkv.weight.grad for b in model.blocks]
    assert len(outs) == CFG["n_layers"]
    assert all(type(o.grad_fn).__name__ == "_FlashAttentionBackward" for o in outs)
    for a, b in zip(grads["flash"], grads["dense"]):
        assert a.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_eval_step_sums_match_jax(params, mesh):
    toks = _tokens(32, seed=9)[0]
    model = JaxLM(**CFG)
    specs = replicated_like(params)
    state = shard_state(TrainState.create({"params": params}, sgd_init(params)),
                        specs, mesh)
    with mesh:
        want = jax_lm.make_lm_eval_step(model, mesh, specs)(
            state, jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("data", None))))
    got = lm.make_lm_eval_step(_port_model(params))(torch.from_numpy(toks))
    for key in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(weights=True), dict(label_smoothing=0.1)])
def test_cross_entropy_matches_jax(kw):
    """f32 and bf16 logits (both promoted to f32 inside), 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(12, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, size=12).astype(np.int32)
    w = (rng.random(12) > 0.3).astype(np.float32) if kw.get("weights") else None
    ls = kw.get("label_smoothing", 0.0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jax_cross_entropy(jnp.asarray(logits, jdt), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w), ls)
        got = cross_entropy(torch.from_numpy(logits).to(dt), torch.from_numpy(labels),
                            None if w is None else torch.from_numpy(w), ls)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_sgd_matches_jax_update():
    """torch.optim.SGD(momentum 0.9, weight decay 1e-4, dampening 0) takes
    the JAX sgd_update's steps: coupled decay, buf = mu*buf + g,
    p -= lr*buf, from a zero buffer (f32, 1e-6)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    gs = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    lrs = (0.1, 0.1, 0.05, 0.02)
    jp, jbuf = jnp.asarray(p0), sgd_init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = sgd([tp])
    for g, lr in zip(gs, lrs):
        jp, jbuf = sgd_update(jnp.asarray(g), jbuf, jp, lr)
        tp.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


def test_datasets_and_schedule_match_jax(tmp_path):
    want = jax_lm.SyntheticTokenDataset(20, 16, 64, seed=3)
    got = lm.SyntheticTokenDataset(20, 16, 64, seed=3)
    for step in (0, 3, 7):
        np.testing.assert_array_equal(got.batch(step, 6), want.batch(step, 6))
    (tmp_path / "a.txt").write_bytes(bytes(range(200)) * 3)
    glob = str(tmp_path / "*.txt")
    for span in ((0.0, 0.9), (0.9, 1.0)):
        want = jax_lm.TextFileDataset(glob, 24, span=span)
        got = lm.TextFileDataset(glob, 24, span=span)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.batch(5, 3), want.batch(5, 3))
    want, got = jax_lm.warmup_cosine_lr(0.1, 5, 40), lm.warmup_cosine_lr(0.1, 5, 40)
    assert [got(s) for s in range(45)] == [want(s) for s in range(45)]


TINY = ["--device", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
        "--n-layers", "1", "--seq-len", "32", "-b", "4", "--steps", "4", "-p", "1"]


def test_recipe_trains_on_cpu(capsys):
    trainer = lm_pretrain.run(TINY + ["--eval-batches", "2", "--generate", "3",
                                      "--warmup-steps", "1", "--clip-grad-norm", "1",
                                      "--accum-steps", "2"])
    assert len(trainer.losses) == 4 and np.isfinite(float(trainer.losses[-1]))
    assert len(trainer.step_times) == 4
    assert len(trainer.eval_history) == 1 and np.isfinite(trainer.best_ppl)
    out = capsys.readouterr().out
    assert out.count("Step: [") == 4 and " * Generated:" in out
    assert np.isfinite(lm_pretrain.main(TINY + ["--no-eval"]))


@pytest.mark.parametrize("flag", [["--ep", "2"], ["--sp", "2"], ["--remat", "--pp", "2"],
                                  ["--elastic"]])
def test_unported_flags_exit_nonzero(flag):
    with pytest.raises(SystemExit) as exc:
        lm_pretrain.main(TINY + flag)
    assert "ROADMAP.md item A" in str(exc.value.code)


@pytest.mark.parametrize("flag", [["--nan-guard"], ["--nan-guard", "--ft-rollback-k", "5"]])
def test_nan_guard_flags_run_and_are_logged(tmp_path, flag):
    """``--nan-guard`` and its knobs are ported: the guard is built with
    them, and every step's record carries its ``nonfinite`` flag."""
    from pytorch_distributed_tpu_torch.obs import metrics

    path = str(tmp_path / "m.jsonl")
    trainer = lm_pretrain.run(TINY + ["--no-eval", "--metrics-jsonl", path] + flag)
    assert trainer.ft_guard.rollback_k == (5 if "--ft-rollback-k" in flag else 3)
    assert trainer.ft_guard.skipped == [] and trainer.ft_guard.lr_scale == 1.0
    rows = [r for r in metrics.read_metrics(path) if "ft_event" not in r]
    assert [r["nonfinite"] for r in rows] == [0.0] * 4


@pytest.mark.parametrize("flag,message", [
    (["--remat"], "--remat applies to the pipeline stages (requires --pp > 1)"),
    (["--accum-steps", "2", "--pp", "2"], "--accum-steps with --pp is redundant"),
    (["--schedule", "1f1b"], "--schedule 1f1b requires --pp > 1")])
def test_jax_argument_checks_come_first_in_the_jax_words(flag, message):
    with pytest.raises(SystemExit) as exc:
        lm_pretrain.main(TINY + flag)
    assert str(exc.value.code).startswith(message)


def test_recipe_defaults_to_cuda_and_raises_without_card(monkeypatch):
    assert lm_pretrain.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_pretrain.main([a for a in TINY if a not in ("--device", "cpu")])
