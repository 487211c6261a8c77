"""Port's image training path vs the JAX package on the same weights and data.

- Train step: 3 SGD steps of the fused tiny Bottleneck ResNet (the JAX
  Pallas kernels in interpret mode; the port's plain kernel versions) with
  ``accum_steps=2`` strided microbatches, a padded weights mask,
  ``log_norms`` and ``guard_nonfinite``, against the JAX ``make_train_step``
  on a one-device mesh (the GSPMD ``global_step``).  f32.  Each step's
  metrics to rtol 1e-4 (loss, top-1/top-5 and the norms agree to ~1e-6
  relative; accuracy is a count of rank comparisons, identical unless two
  logits tie to 1e-6); parameters and running statistics after step 3 to
  atol 1e-4, rtol 1e-3: gradients differ by summation order (~1e-6
  relative), and three steps of lr up to 0.1 with momentum 0.9, through
  BatchNorm over microbatches of 4, carry that into the weights.
- Eval sums, data (dataset, sampler, padded loader), LR schedules and top-k
  metrics: exact or 1e-6 (the same numpy code, f32 sums).
- The recipe on the CPU, its not-ported flags, and the card by default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import loader as jax_loader
from pytorch_distributed_tpu.data.datasets import SyntheticImageDataset as JaxSynthetic
from pytorch_distributed_tpu.data.sampler import DistributedShardSampler as JaxSampler
from pytorch_distributed_tpu.models import resnet as jr
from pytorch_distributed_tpu.ops.metrics import accuracy as jax_accuracy
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.train import lr as jax_lr
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu.train.steps import make_eval_step as jax_eval_step
from pytorch_distributed_tpu.train.steps import make_train_step as jax_train_step
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DeviceFeeder,
    DistributedShardSampler,
    SyntheticImageDataset,
)
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.ops.fused_conv_bn import fused_dgrad_wgrad
from pytorch_distributed_tpu_torch.ops.metrics import accuracy, topk_correct
from pytorch_distributed_tpu_torch.recipes import tpu_native
from pytorch_distributed_tpu_torch.train import lr
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_eval_step, make_train_step
from pytorch_distributed_tpu_torch.utils.convert import resnet_state_dict_from_jax

TINY = dict(stage_sizes=[1, 1], num_classes=7, num_filters=16)
LRS = (0.1, 0.05, 0.02)


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
    return build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])


@pytest.fixture(scope="module")
def variables():
    jm = jr.ResNet(block_cls=jr.Bottleneck, **TINY)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(7),
                                                  jnp.zeros((1, 8, 8, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def _batches(n=3, batch=8, seed=4):
    rng = np.random.default_rng(seed)
    weights = np.array([1.0] * (batch - 2) + [0.0] * 2, np.float32)
    return [{"images": rng.normal(size=(batch, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 7, size=batch).astype(np.int32),
             "weights": weights} for _ in range(n)]


def _port_model(variables, fused=True):
    model = tr.ResNet(block_cls=tr.Bottleneck, fused_convbn=fused, device="cpu", **TINY)
    model.load_state_dict(resnet_state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]))
    return model


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_train_steps_match_jax(mesh, variables):
    batches = _batches()
    jm = jr.ResNet(block_cls=jr.Bottleneck, fused_convbn=True, **TINY)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = TrainState.create(v, sgd_init(v["params"]))
    jstep = jax_train_step(jm, mesh, accum_steps=2, log_norms=True, guard_nonfinite=True)
    want = []
    for b, rate in zip(batches, LRS):
        state, m = jstep(state, {k: jnp.asarray(x) for k, x in b.items()}, jnp.float32(rate))
        want.append({k: float(x) for k, x in m.items()})

    model = _port_model(variables)
    step = make_train_step(model, sgd(model.parameters()), accum_steps=2, log_norms=True,
                           guard_nonfinite=True)
    got = [{k: float(x) for k, x in step(_torch_batch(b), rate).items()}
           for b, rate in zip(batches, LRS)]
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        assert g["nonfinite"] == w["nonfinite"] == 0.0
        np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                   rtol=1e-4, atol=1e-6)
    final = resnet_state_dict_from_jax(jax.device_get(state.params),
                                       jax.device_get(state.batch_stats))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def test_nonfinite_batch_leaves_the_state_untouched(variables):
    """guard_nonfinite: a NaN image poisons loss and gradients; parameters,
    momentum and BN statistics come back as they were, with no host sync in
    the step.  The next finite step then runs."""
    model = _port_model(variables)
    opt = sgd(model.parameters())
    step = make_train_step(model, opt, guard_nonfinite=True)
    good, bad = _batches(2)
    step(_torch_batch(good), 0.1)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    moms = [opt.state[p]["momentum_buffer"].clone() for p in model.parameters()]
    bad["images"][0, 0, 0, 0] = np.nan
    assert float(step(_torch_batch(bad), 0.1)["nonfinite"]) == 1.0
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    for p, m in zip(model.parameters(), moms):
        assert torch.equal(opt.state[p]["momentum_buffer"], m)
    assert float(step(_torch_batch(good), 0.1)["nonfinite"]) == 0.0
    assert not torch.equal(model.fc.weight, before["fc.weight"])


def test_eval_sums_match_jax(mesh, variables):
    b = _batches(1, seed=9)[0]
    jm = jr.ResNet(block_cls=jr.Bottleneck, **TINY)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    want = jax_eval_step(jm, mesh)(TrainState.create(v, sgd_init(v["params"])),
                                   {k: jnp.asarray(x) for k, x in b.items()})
    fused_dgrad_wgrad.launches = 0
    got = make_eval_step(_port_model(variables))(_torch_batch(b))
    assert fused_dgrad_wgrad.launches == 0
    for key in ("loss_sum", "correct1", "correct5", "count"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


def test_data_matches_jax():
    """Same samples, permutations, padding and masks as the JAX pipeline."""
    want, got = JaxSynthetic(10, 7, 8, seed=3), SyntheticImageDataset(10, 7, 8, seed=3)
    for i in (0, 4, 9):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    for kw in (dict(shuffle=True, seed=2), dict(shuffle=False), dict(drop_last=True)):
        js, ts = JaxSampler(10, 3, 1, **kw), DistributedShardSampler(10, 3, 1, **kw)
        js.set_epoch(5)
        ts.set_epoch(5)
        for a, b in zip(ts.shard(), js.shard()):
            np.testing.assert_array_equal(a, b)
    for drop_last, shuffle in ((False, False), (True, True)):
        jl = jax_loader.DataLoader(want, 4, sampler=JaxSampler(10, shuffle=shuffle, seed=1),
                                   num_workers=2, drop_last=drop_last, seed=1)
        tl = DataLoader(got, 4, sampler=DistributedShardSampler(10, shuffle=shuffle, seed=1),
                        num_workers=2, drop_last=drop_last)
        jl.set_epoch(1)
        tl.set_epoch(1)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) == (2 if drop_last else 3)
        for a, b in zip(tb, jb):
            for key in ("images", "labels", "weights"):
                np.testing.assert_array_equal(a[key], b[key])
    fed = list(DeviceFeeder("cpu")(iter(tb)))
    assert all(torch.equal(f["images"], torch.from_numpy(b["images"])) for f, b in zip(fed, tb))


def test_schedules_and_metrics_match_jax():
    for epoch in range(0, 95, 7):
        assert lr.step_decay_lr(0.1, epoch) == jax_lr.step_decay_lr(0.1, epoch)
        assert lr.cosine_lr(0.1, epoch, 90, 5) == jax_lr.cosine_lr(0.1, epoch, 90, 5)
    assert lr.linear_scaled_lr(0.1, 1024) == jax_lr.linear_scaled_lr(0.1, 1024)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    logits[3, :] = logits[3, 2]  # a row of ties
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    w = (rng.random(16) > 0.3).astype(np.float32)
    for weights in (None, w):
        want = jax_accuracy(jnp.asarray(logits), jnp.asarray(labels), (1, 5),
                            None if weights is None else jnp.asarray(weights))
        got = accuracy(torch.from_numpy(logits), torch.from_numpy(labels), (1, 5),
                       None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose([float(g) for g in got], [float(x) for x in want],
                                   rtol=1e-6)
    assert float(topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), 1)[3]) == 1.0


TINY_ARGS = ["--device", "cpu", "-a", "resnet18", "--synthetic", "--image-size", "16",
             "-b", "4", "--synthetic-length", "8", "--epochs", "1", "-p", "1", "-j", "2",
             "--num-classes", "10", "--seed", "1"]


def test_recipe_trains_on_cpu(tmp_path, capsys):
    csv = tmp_path / "epochs.csv"
    trainer = tpu_native.run(TINY_ARGS + ["--fused-convbn", "--nan-guard",
                                          "--accum-steps", "2", "--epoch-csv", str(csv),
                                          "--checkpoint-dir", str(tmp_path)])
    assert len(trainer.losses) == 2 and all(np.isfinite(float(x)) for x in trainer.losses)
    assert trainer.model.dtype == torch.bfloat16  # the recipe's precision default
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert len(trainer.eval_history) == 1 and len(trainer.val_loader) == 1
    out = capsys.readouterr().out
    assert out.count("Epoch: [0]") == 2 and " * Acc@1 " in out
    assert csv.read_text().splitlines()[0] == "timestamp,epoch_seconds"
    assert (tmp_path / "checkpoint.msgpack").exists()  # the epoch-end save
    assert 0.0 <= tpu_native.main(TINY_ARGS + ["--precision", "fp32", "--epoch-csv",
                                               str(csv), "-e"]) <= 100.0


@pytest.mark.parametrize("flag,reason", [
    (["--min-ranks", "2"], "ROADMAP.md item A11"), (["--mem-ledger", "m"], "ROADMAP.md item A12"),
    (["--rescale-lr", "linear"], "ROADMAP.md item A11"), (["--elastic"], "ROADMAP.md item A11"),
    (["--ckpt-backend", "orbax"], "orbax.checkpoint imports JAX"),
    (["--lowering-cache", "lc"], "ROADMAP.md item A12"),
    (["--watch-recompiles"], "ROADMAP.md item A12"),
    (["--comm-ledger", "c.json"], "ROADMAP.md item A12")])
def test_unported_flags_exit_naming_their_item(flag, reason):
    with pytest.raises(SystemExit) as exc:
        tpu_native.main(TINY_ARGS + flag)
    assert reason in str(exc.value.code)
    # Without --synthetic the default --data names no tree here: the JAX
    # package's ImageFolder error.
    with pytest.raises(FileNotFoundError, match="ImageNet2012/train"):
        tpu_native.main([a for a in TINY_ARGS if a != "--synthetic"])


@pytest.mark.parametrize("flag,attr", [(["--ft-rollback-k", "5"], "rollback_k"),
                                       (["--ft-check-every", "5"], "check_every")])
def test_ft_flags_run_and_are_logged(tmp_path, flag, attr):
    """The divergence guard's knobs are ported: with ``--nan-guard`` they
    reach the guard, and every step's record carries its ``nonfinite``
    flag (0 here: f32, no poisoned batch)."""
    from pytorch_distributed_tpu_torch.obs import metrics

    path = str(tmp_path / "m.jsonl")
    trainer = tpu_native.run(TINY_ARGS + ["--precision", "fp32", "--nan-guard", "--metrics-jsonl",
                                          path, "--epoch-csv", str(tmp_path / "e.csv"),
                                          "--checkpoint-dir", str(tmp_path)] + flag)
    assert getattr(trainer.ft_guard, attr) == 5 and trainer.ft_guard.skipped == []
    rows = [r for r in metrics.read_metrics(path) if "ft_event" not in r]
    assert [r["nonfinite"] for r in rows] == [0.0] * len(trainer.losses) == [0.0, 0.0]


def test_sync_bn_and_fused_ce_without_a_group_change_nothing(tmp_path):
    """``--sync-bn`` without a process group and ``--fused-ce 4`` (an LM
    flag the JAX image trainer never reads) both run, and their losses are
    bitwise those of the run without them (f32)."""
    args = TINY_ARGS + ["--precision", "fp32", "--epoch-csv", str(tmp_path / "e.csv"),
                        "--checkpoint-dir", str(tmp_path)]
    want = [float(x) for x in tpu_native.run(args).losses]
    for flags in (["--sync-bn"], ["--fused-ce", "4", "--fused-ce-mode", "dp"]):
        assert [float(x) for x in tpu_native.run(args + flags).losses] == want


def test_explicit_step_refuses_sync_bn_with_fused_convbn(tmp_path, monkeypatch):
    """The JAX trainer's refusal, word for word, on ``horovod_distributed``
    at a gloo world of one; the group is taken down again."""
    import socket

    from pytorch_distributed_tpu_torch.recipes import horovod_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES="1",
                     PTD_TPU_PROCESS_ID="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="^--sync-bn and --fused-convbn are mutually "
                       "exclusive: the fused conv\\+BN backward has no cross-replica "
                       "statistics variant; drop one of the flags$"):
        horovod_distributed.main(TINY_ARGS + ["--sync-bn", "--fused-convbn",
                                              "--checkpoint-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()


def test_recipe_defaults_to_cuda_and_raises_without_card(monkeypatch):
    from pytorch_distributed_tpu_torch.train.config import build_parser

    assert build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_native.main([a for a in TINY_ARGS if a not in ("--device", "cpu")])
