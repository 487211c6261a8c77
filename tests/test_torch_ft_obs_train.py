"""The death paths and the live plane through both trainers of the port, on
the CPU, against the JAX package's ``LMTrainer`` where it runs the same
story.

- Preemption: a tiny ``LMTrainer`` (vocab 32, d 32, 1 layer, the JAX
  preemption test's shape) with ``SignalAt`` under a ``PreemptionGuard``
  stops and checkpoints at the step where the JAX trainer stops, with the
  same records and ``preempt`` event (losses within the 3-LM-step row, rtol
  1e-5); resumed, its losses and weights are the uninterrupted run's.  The
  image ``Trainer`` at ``tpu_native``'s tiny arguments, through its own
  guard on ``--preempt-signals``, stops mid-epoch where the JAX ``Trainer``
  stops, with the same losses, checkpoint record and ``preempt`` event.
- The exception path dumps ``exception:<Type>`` (``checkpoint_corrupt``
  for a corrupt checkpoint) with the step window in the ring.
- A stalled step (``HangAt``) fires the watchdog: a ``hang`` event, an
  ``alert`` of the rule ``hang`` and a ``hang`` dump.
- ``prefetch=2`` and ``prefetch=0`` give bitwise-equal losses.
- ``tpu_native`` and ``lm_pretrain`` with ``--flight-rec --hang-timeout
  --metrics-port --alerts default`` run healthy: no dump, no alert, the
  exporter serving the last record and stopped at the end.
"""

import json
import os
import signal
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ft import chaos as jchaos
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.obs import metrics as jmetrics
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.config import parse_config as jax_parse_config
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.utils import preempt as jpreempt
from pytorch_distributed_tpu_torch.ft import chaos, divergence
from pytorch_distributed_tpu_torch.ft.integrity import CheckpointCorruptError
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.obs import export, flightrec, metrics
from pytorch_distributed_tpu_torch.recipes import lm_pretrain, tpu_native
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils.convert import (lm_state_dict_from_jax,
                                                          resnet_state_dict_from_jax)
from pytorch_distributed_tpu_torch.utils.preempt import PreemptionGuard
from tests.test_torch_zoo import jitted_flax_init  # noqa: F401  (fixture)

LM = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=1)
# The JAX trainers' weights are copied into the port, so their init may be
# compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")
STEPS, SIGNAL_AT = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_init():
    return jax.device_get(jax.jit(JaxLM(**LM, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])


def _port_lm(params, **kw):
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params))
    return lm.LMTrainer(model, lm.SyntheticTokenDataset(32, 16, 32, seed=0), 8, lr=0.05, **kw)


def _steps(path):
    return [r for r in metrics.read_metrics(path) if "ft_event" not in r]


def _events(path):
    return [r for r in metrics.read_metrics(path) if "ft_event" in r]


def test_lm_preemption_stops_where_jax_stops_and_resumes(tmp_path, lm_init, capsys):
    guard = jpreempt.PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
        with mesh:
            jt = jax_lm.LMTrainer(JaxLM(**LM, dtype=jnp.float32), mesh,
                                  jax_lm.SyntheticTokenDataset(32, 16, 32, seed=0), 8, lr=0.05,
                                  seed=0, prefetch=0, checkpoint_dir=str(tmp_path / "jax"),
                                  metrics_jsonl=str(tmp_path / "jax.jsonl"), preempt=guard,
                                  chaos=jchaos.ChaosSchedule(
                                      jchaos.SignalAt(SIGNAL_AT, signal.SIGUSR1)))
            jt.state = jt.state.replace(params=jax.tree_util.tree_map(jnp.asarray, lm_init))
            jt.fit(STEPS, print_freq=1)
    finally:
        guard.uninstall()
    want_stop = int(jt.state.step)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        t = _port_lm(lm_init, checkpoint_dir=str(tmp_path / "port"), preempt=guard,
                     metrics_jsonl=str(tmp_path / "port.jsonl"),
                     chaos=chaos.ChaosSchedule(chaos.SignalAt(SIGNAL_AT, signal.SIGUSR1)))
        t.fit(STEPS, print_freq=1)
    finally:
        guard.uninstall()
    assert f"=> preemption signal: stopping at step {want_stop}" in capsys.readouterr().out
    assert 0 < want_stop < STEPS and len(t.losses) == want_stop
    # Both files (the port reads either) hold the stop step.
    path = os.path.join(tmp_path, "port", ckpt.CHECKPOINT_NAME)
    for f in (path, os.path.join(tmp_path, "jax", ckpt.CHECKPOINT_NAME)):
        _, meta = ckpt.load_checkpoint(f, _port_lm(lm_init).model)
        assert (meta["ft"]["step"], meta["ft"]["global_step"]) == (want_stop, want_stop)
    got, want = _steps(str(tmp_path / "port.jsonl")), _steps(str(tmp_path / "jax.jsonl"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(want_stop))
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-5)
    ev = [(e["ft_event"], e["step"]) for e in _events(str(tmp_path / "port.jsonl"))]
    assert ev == [(e["ft_event"], e["step"]) for e in _events(str(tmp_path / "jax.jsonl"))]
    assert ev == [("preempt", want_stop)]
    # Resumed, the run is the uninterrupted one.
    ref = _port_lm(lm_init)
    ref.fit(STEPS, print_freq=100)
    resumed = _port_lm(lm_init, resume=path)
    resumed.fit(STEPS, print_freq=100)
    assert resumed._start_step == want_stop
    want_losses = [float(x) for x in ref.losses]
    np.testing.assert_allclose([float(x) for x in t.losses + resumed.losses], want_losses,
                               rtol=1e-5)
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            ref.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=2e-5, err_msg=name)


# fp32: the CPU's bf16 conv backward note of tests/test_torch_checkpoint.py.
TINY_IMG = ["--device", "cpu", "-a", "resnet18", "--synthetic", "--image-size", "16",
            "-b", "4", "--synthetic-length", "16", "--epochs", "1", "-p", "1", "-j", "2",
            "--num-classes", "10", "--seed", "1", "--precision", "fp32"]


def test_image_preemption_checkpoints_mid_epoch_and_resumes(tmp_path, capsys):
    """JAX ``tests/test_preempt.py::test_trainer_mid_epoch_preemption_resumes_at_exact_step``
    on both trainers, each through its own guard on ``--preempt-signals
    usr1``: SIGUSR1 at step 1 (``SignalAt``), agreed at a ``-p 1`` poll.
    The port stops, checkpoints and logs its ``preempt`` event where the
    JAX ``Trainer`` does, from the same weights with the same losses;
    resumed, its epoch ends where an uninterrupted one does."""
    before = signal.getsignal(signal.SIGUSR1)
    flags = ["--preempt-signals", "usr1", "--epoch-csv", str(tmp_path / "e.csv")]
    jargv = [a for a in TINY_IMG if a not in ("--device", "cpu")] + flags + [
        "--checkpoint-dir", str(tmp_path / "jax"), "--metrics-jsonl", str(tmp_path / "jax.jsonl")]
    jt = JaxTrainer(jax_parse_config(jargv), mesh=build_mesh(MeshSpec(("data",), (1,)),
                                                              jax.devices()[:1]),
                    chaos=jchaos.ChaosSchedule(jchaos.SignalAt(1, signal.SIGUSR1)))
    init = resnet_state_dict_from_jax(*jax.device_get((jt.state.params, jt.state.batch_stats)))
    jt.fit()
    jout = capsys.readouterr().out
    want_stop = int(jt._global_step)
    assert 0 < want_stop < 4 and signal.getsignal(signal.SIGUSR1) == before
    jlines = [ln for ln in jout.splitlines() if ln.startswith("=> preemption signal")]

    def port(argv, **kw):
        t = Trainer(parse_config(TINY_IMG + ["--epoch-csv", str(tmp_path / "e.csv")] + argv),
                    **kw)
        t.model.load_state_dict(init)
        return t

    ref = port(["--checkpoint-dir", str(tmp_path / "a")])
    ref.fit()
    d = str(tmp_path / "b")
    first = port(["--checkpoint-dir", d, "--preempt-signals", "usr1",
                  "--metrics-jsonl", str(tmp_path / "m.jsonl"), "--flight-rec",
                  str(tmp_path / "fr")],
                 chaos=chaos.ChaosSchedule(chaos.SignalAt(1, signal.SIGUSR1)))
    first.fit()
    out = capsys.readouterr().out
    assert jlines and [ln for ln in out.splitlines()
                       if ln.startswith("=> preemption signal")] == jlines
    assert first.preempted and len(first.losses) == want_stop and first.eval_history == []
    # The signal dumped the ring, then reached the guard; both handlers are
    # taken down after fit.
    doc = json.loads(open(flightrec.dump_path(str(tmp_path / "fr"), 0)).read())
    assert doc["reason"] == f"signal:{int(signal.SIGUSR1)}"
    assert signal.getsignal(signal.SIGUSR1) == before
    path = os.path.join(d, ckpt.CHECKPOINT_NAME)
    ft = []
    for f in (path, os.path.join(tmp_path, "jax", ckpt.CHECKPOINT_NAME)):
        _, meta = ckpt.load_checkpoint(f, first.model)
        ft.append((meta["epoch"], meta["ft"]["step"], meta["ft"]["global_step"],
                   meta["ft"]["sampler_seed"]))
    assert ft[0] == ft[1] and ft[0][:3] == (0, want_stop, want_stop)
    got, want = _steps(str(tmp_path / "m.jsonl")), _steps(str(tmp_path / "jax.jsonl"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(want_stop))
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-4)
    ev = [(e["ft_event"], e["step"], e["epoch"], e["step_in_epoch"])
          for e in _events(str(tmp_path / "m.jsonl"))]
    assert ev == [(e["ft_event"], e["step"], e["epoch"], e["step_in_epoch"])
                  for e in _events(str(tmp_path / "jax.jsonl"))]
    assert ev == [("preempt", want_stop, 0, want_stop)]
    resumed = Trainer(parse_config(TINY_IMG + ["--checkpoint-dir", d, "--resume", path,
                                               "--epoch-csv", str(tmp_path / "e.csv")]))
    assert (resumed.cfg.start_epoch, resumed._resume_step) == (0, want_stop)
    resumed.fit()
    np.testing.assert_allclose([float(x) for x in first.losses + resumed.losses],
                               [float(x) for x in ref.losses], rtol=1e-6)
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            ref.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


class _Boom(chaos.ChaosInjector):
    def __init__(self, exc):
        self.exc = exc

    def on_step(self, trainer, step):
        if step == 1:
            raise self.exc("chaos boom")


@pytest.mark.parametrize("exc,reason", [(RuntimeError, "exception:RuntimeError"),
                                        (CheckpointCorruptError, "checkpoint_corrupt")])
def test_exception_dumps_the_ring(tmp_path, lm_init, exc, reason):
    """JAX ``tests/test_flightrec.py::test_trainer_dumps_on_unhandled_exception``
    on the port: the ring lands on disk with the reason before the error
    propagates, holding step 0's whole window."""
    t = _port_lm(lm_init, chaos=chaos.ChaosSchedule(_Boom(exc)), flight_rec=str(tmp_path),
                 hang_timeout=300.0)
    with pytest.raises(exc, match="chaos boom"):
        t.fit(4, print_freq=2)
    doc = json.loads(open(flightrec.dump_path(str(tmp_path), 0)).read())
    assert doc["reason"] == reason
    assert [e["error"] for e in doc["events"] if e["kind"] == "exception"] == [exc.__name__]
    assert {"step_begin", "coll_enter", "coll_exit", "step_end"} <= \
        {e["kind"] for e in doc["events"]}
    assert doc["membership"]["world"] == 1 and doc["last_collective"]["step"] == 0


def test_stalled_step_fires_the_watchdog_and_the_hang_alert(tmp_path, lm_init):
    t = _port_lm(lm_init, chaos=chaos.ChaosSchedule(chaos.HangAt(2, 1.5)),
                 flight_rec=str(tmp_path), hang_timeout=0.5, alerts="default",
                 metrics_jsonl=str(tmp_path / "m.jsonl"))
    t.fit(4, print_freq=100)
    assert t.ro.hang_wd.hangs >= 1 and t.ro.hang_wd._thread is None
    events = _events(str(tmp_path / "m.jsonl"))
    assert 2 in [e["step"] for e in events if e["ft_event"] == "hang"]
    assert [e["rule"] for e in events if e["ft_event"] == "alert"] == ["hang"]
    doc = json.loads(open(flightrec.dump_path(str(tmp_path), 0)).read())
    assert doc["reason"] == "hang"
    assert {"hang", "alert"} <= {e["kind"] for e in doc["events"]}


def test_prefetch_two_and_zero_give_bitwise_losses(lm_init):
    runs = []
    for prefetch in (0, 2):
        t = _port_lm(lm_init, prefetch=prefetch)
        t.fit(5, print_freq=100)
        runs.append([float(x) for x in t.losses])
    assert runs[0] == runs[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("recipe", ["tpu_native", "lm_pretrain"])
def test_recipes_run_healthy_with_the_flags(tmp_path, recipe):
    port = _free_port()
    flags = ["--flight-rec", str(tmp_path / "fr"), "--hang-timeout", "30", "--metrics-port",
             str(port), "--alerts", "default", "--metrics-jsonl", str(tmp_path / "m.jsonl")]
    built = []   # the recipe's ``before_fit`` hook sees the trainer it returns
    if recipe == "tpu_native":
        trainer = tpu_native.run(TINY_IMG + flags + ["--checkpoint-dir", str(tmp_path / "ck"),
                                                     "--epoch-csv", str(tmp_path / "e.csv")],
                                 before_fit=built.append)
    else:
        trainer = lm_pretrain.run(["--device", "cpu", "--vocab", "64", "--d-model", "32",
                                   "--n-heads", "4", "--n-layers", "1", "--seq-len", "32",
                                   "-b", "4", "--steps", "3", "-p", "1", "--no-eval"] + flags,
                                  before_fit=built.append)
    assert len(built) == 1 and built[0] is trainer
    exp = trainer.ro.exporter
    assert exp.port == port and not exp.running and trainer.ro.alerts is not None
    assert flightrec.find_dumps(str(tmp_path / "fr")) == {}
    recs = metrics.read_metrics(str(tmp_path / "m.jsonl"))
    assert recs == jmetrics.read_metrics(str(tmp_path / "m.jsonl"))
    assert not [r for r in recs if "ft_event" in r] and not trainer.ro.alerts.history
    samples = export.parse_prometheus(exp.render())
    last = recs[-1]
    assert export.sample_value(samples, "ptd_step", rank=0) == last["step"]
    assert export.sample_value(samples, "ptd_metric", rank=0, field="loss") == \
        float(f"{last['loss']:g}")
    assert export.sample_value(samples, "ptd_alert_firing") is None


class _StateWatch(chaos.ChaosInjector):
    """Copies the train state just before each step (the ``on_collective``
    hook), so a test can tell whether a step moved it."""

    def __init__(self):
        self.before = {}

    def on_collective(self, trainer, step):
        self.before[step] = [t.detach().clone() if t is not None else None for t in
                             divergence._state_tensors(trainer.model, trainer.optimizer,
                                                       trainer.comm)]


def test_image_gate_and_rollback_follow_the_jax_trainer(tmp_path):
    """The divergence guard on both image trainers from the same weights:
    ``NaNBatchAt`` poisons step 1 alone (a skip) and steps 3 and 4 (two in a
    row: with K 2 and a save every 2 steps, the drain at the boundary after
    step 5 rolls back to the start, the last boundary whose flags were
    clean).  The same skipped steps, rollback, restored step, LR scale and
    ``ft_event`` records; each poisoned step left the port's weights,
    momentum and BN statistics bitwise as they were, and the rollback
    restored the initial weights bitwise; losses and final state (two
    steps at half the LR after it) within the 3-image-step row (f32).  At
    lr 0.01: at the fixture's 0.1 this net (BatchNorm over 4 images of 16
    px) is chaotic, and its third step's loss moves 1.6e-4 between the
    packages (3.9e-6 at the second)."""
    guard = ["--lr", "0.01", "--nan-guard", "--ft-rollback-k", "2", "--ft-check-every", "3", "--save-steps",
             "2", "--synthetic-length", "32", "--epoch-csv", str(tmp_path / "e.csv")]
    poison = (1, 3, 4)
    jargv = [a for a in TINY_IMG if a not in ("--device", "cpu")] + guard + [
        "--checkpoint-dir", str(tmp_path / "jax"), "--metrics-jsonl", str(tmp_path / "jax.jsonl")]
    jt = JaxTrainer(jax_parse_config(jargv), mesh=build_mesh(MeshSpec(("data",), (1,)),
                                                              jax.devices()[:1]),
                    chaos=jchaos.ChaosSchedule(jchaos.NaNBatchAt(poison, keys=("images",))))
    init = resnet_state_dict_from_jax(*jax.device_get((jt.state.params, jt.state.batch_stats)))
    jt.fit()
    watch = _StateWatch()
    t = Trainer(parse_config(TINY_IMG + guard + ["--checkpoint-dir", str(tmp_path / "port"),
                                                 "--metrics-jsonl", str(tmp_path / "m.jsonl")]),
                chaos=chaos.ChaosSchedule(chaos.NaNBatchAt(poison, keys=("images",)), watch))
    t.model.load_state_dict(init)
    t.fit()
    g, j = t.ft_guard, jt.ft_guard
    assert (g.skipped, g.rollbacks, g.lr_scale, g.consecutive) == \
        (j.skipped, j.rollbacks, j.lr_scale, j.consecutive) == ([1, 3, 4], 1, 0.5, 0)
    assert t._keeper.step == jt._keeper.step == 8   # refreshed at the epoch-end save
    n = len(list(t.model.parameters())) + len(list(t.model.buffers()))
    assert all(torch.equal(a, b) for a, b in zip(watch.before[6][:n], watch.before[0][:n]))
    assert all(m is None or not m.any() for m in watch.before[6][n:])
    for s in (1, 3, 4):
        for a, b in zip(watch.before[s], watch.before[s + 1]):
            assert a is None or torch.equal(a, b)
    got, want = metrics.read_metrics(str(tmp_path / "m.jsonl")), \
        jmetrics.read_metrics(str(tmp_path / "jax.jsonl"))
    events = [[{k: v for k, v in r.items() if k != "t"} for r in recs if "ft_event" in r]
              for recs in (got, want)]
    assert events[0] == events[1]
    assert [e["ft_event"] for e in events[0]] == ["skip", "skip", "skip", "rollback"]
    rows = [[r for r in recs if "ft_event" not in r] for recs in (got, want)]
    assert [r["nonfinite"] for r in rows[0]] == [r["nonfinite"] for r in rows[1]] == \
        [float(s in poison) for s in range(8)]
    np.testing.assert_allclose([r["loss"] for r in rows[0]], [r["loss"] for r in rows[1]],
                               rtol=1e-4)
    want_state = resnet_state_dict_from_jax(*jax.device_get((jt.state.params,
                                                             jt.state.batch_stats)))
    for name, a in t.model.state_dict().items():
        if name in want_state:
            np.testing.assert_allclose(a.numpy(), want_state[name].numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=name)
    # The JAX trainer's epoch-end file carries its scale into the port's guard.
    resumed = Trainer(parse_config(TINY_IMG + guard + [
        "--checkpoint-dir", str(tmp_path / "r"),
        "--resume", os.path.join(tmp_path, "jax", ckpt.CHECKPOINT_NAME)]))
    assert resumed.ft_guard.lr_scale == 0.5
