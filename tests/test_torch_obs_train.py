"""The metrics stream through both trainers of the port, against the JAX
package's on the CPU.

- A tiny ``LMTrainer`` (the JAX efficiency test's shape: vocab 32, d 32,
  1 layer, 4 steps) runs on both packages from the same weights with
  ``metrics_jsonl``, ``mfu``, ``goodput`` and ``step_attr``: the same
  records and keys (timings aside), ``loss``, ``lr``, ``grad_norm`` and
  ``param_norm`` each step within the 3-LM-step tolerance (rtol 1e-5), the
  same model FLOPs and phase ledger; the JAX readers fold the port's file
  as the port's copies do.
- ``tpu_native`` and ``lm_pretrain`` run their tiny arguments with every
  flag of the slice and write every file (records, heartbeats, telemetry,
  a Chrome trace with the step's spans), which the JAX readers and
  ``scripts/obs_report.py`` fold.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.obs import goodput as jgoodput
from pytorch_distributed_tpu.obs import heartbeat as jheartbeat
from pytorch_distributed_tpu.obs import metrics as jmetrics
from pytorch_distributed_tpu.obs import stepattr as jstepattr
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.obs import goodput, heartbeat, metrics, stepattr
from pytorch_distributed_tpu_torch.recipes import lm_pretrain, tpu_native
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax
from tests.test_torch_zoo import jitted_flax_init  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=1)
# The JAX trainers' weights are copied into the port (or replaced), so their
# init may be compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")
TIMING = {"t", "step_time", "step_time_ema", "step_time_p50", "step_time_p95",
          "step_time_max", "throughput", "mfu", "hfu", "model_tflops", "data_wait_share"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obs_report():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import obs_report
    return obs_report


def _readers_agree(path):
    """The JAX readers fold ``path`` as the port's copies do; returns the
    records."""
    recs = metrics.read_metrics(path)
    assert recs == jmetrics.read_metrics(path)
    assert (dataclasses.asdict(goodput.compute_goodput(recs))
            == dataclasses.asdict(jgoodput.compute_goodput(recs)))
    assert stepattr.summarize(recs) == jstepattr.summarize(recs)
    return recs


def test_lm_trainer_records_match_jax(tmp_path):
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    want_path, got_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    kw = dict(metrics_jsonl=None, mfu=True, goodput=True, step_attr=True)
    jtrainer = jax_lm.LMTrainer(JaxLM(**LM, dtype=jnp.float32), mesh,
                                jax_lm.SyntheticTokenDataset(16, 16, 32, seed=0), 4, lr=0.05,
                                seed=0, prefetch=0, **{**kw, "metrics_jsonl": want_path})
    init = jax.device_get(jtrainer.state.params)
    with mesh:
        jtrainer.fit(4, print_freq=2)
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(init))
    trainer = lm.LMTrainer(model, lm.SyntheticTokenDataset(16, 16, 32, seed=0), 4, lr=0.05,
                           **{**kw, "metrics_jsonl": got_path})
    trainer.fit(4, print_freq=2)

    want, got = jmetrics.read_metrics(want_path), _readers_agree(got_path)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    steps = [(g, w) for g, w in zip(got, want) if "ft_event" not in g]
    assert len(steps) == 4 and [g["step"] for g, _ in steps] == [0, 1, 2, 3]
    for g, w in steps:
        np.testing.assert_allclose([g[k] for k in ("loss", "lr", "grad_norm", "param_norm",
                                                   "acc")],
                                   [w[k] for k in ("loss", "lr", "grad_norm", "param_norm",
                                                   "acc")], rtol=1e-5)
        # The same model FLOPs (and the CPU placeholder peak) over each
        # side's own step time; the same tokens per step.
        for side in (g, w):
            side["flops"] = side["model_tflops"] * 1e12 * side["step_time"]
            side["mfu_s"] = side["mfu"] * side["step_time"]
        np.testing.assert_allclose([g["flops"], g["mfu_s"], g["throughput"] * g["step_time"]],
                                   [w["flops"], w["mfu_s"], w["throughput"] * w["step_time"]],
                                   rtol=1e-9)
        assert g["hfu"] == g["mfu"] and g["attr_recon_err_ms"] >= 0.0
        assert {k: v for k, v in g.items() if k.startswith("attr_") and k not in TIMING} \
            .keys() == {k for k in w if k.startswith("attr_")}
    events = [(g, w) for g, w in zip(got, want) if "ft_event" in g]
    assert [g["ft_event"] for g, _ in events] == ["stepattr_phases"]
    g, w = events[0]
    assert {k: v for k, v in g.items() if k != "t"} == {k: v for k, v in w.items() if k != "t"}
    assert trainer.ro.goodput.report().steps == jtrainer._goodput.report().steps == 4


def test_tpu_native_writes_every_file_with_every_flag(tmp_path):
    d = tmp_path
    args = ["--device", "cpu", "-a", "resnet18", "--synthetic", "--image-size", "16", "-b", "4",
            "--synthetic-length", "16", "--epochs", "1", "-p", "1", "-j", "2",
            "--num-classes", "10", "--seed", "1", "--fused-convbn", "--precision", "fp32",
            "--checkpoint-dir", str(d / "ck"), "--epoch-csv", str(d / "e.csv"),
            "--metrics-jsonl", str(d / "m.jsonl"), "--hb-dir", str(d / "hb"),
            "--hb-interval", "0", "--mfu", "--goodput", "--step-attr",
            "--telemetry-csv", str(d / "t.csv"), "--profile-dir", str(d / "prof"),
            "--profile-steps", "2:3"]
    trainer = tpu_native.run(args)
    recs = _readers_agree(str(d / "m.jsonl"))
    steps = [r for r in recs if "ft_event" not in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    for r in steps:
        assert r["mfu"] > 0 and r["hfu"] >= r["mfu"] and np.isfinite(r["grad_norm"])
        assert r["epoch"] == 0 and r["attr_device_ms"] > 0
    assert [r["ft_event"] for r in recs if "ft_event" in r] == ["stepattr_phases"]
    beats = heartbeat.read_heartbeats(str(d / "hb"))
    assert beats == jheartbeat.read_heartbeats(str(d / "hb")) and beats[0]["step"] == 3
    rows = [line.split(",") for line in open(d / "t.csv").read().splitlines()]
    assert rows and all(len(r) == 5 and r[2] == "0" for r in rows)
    (trace,) = os.listdir(d / "prof")
    text = open(d / "prof" / trace).read()
    for span in ("train_step", "forward", "loss_and_metrics", "grad_sync", "optimizer"):
        assert f'"{span}"' in text
    assert trainer.ro.goodput.report().steps == 4
    obs_report = _obs_report()
    assert obs_report.main(["--metrics-jsonl", str(d / "m.jsonl"), "--hb-dir", str(d / "hb"),
                            "--telemetry-csv", str(d / "t.csv")]) == 0


def test_lm_pretrain_writes_every_file_with_every_flag(tmp_path, capsys):
    d = tmp_path
    lm_pretrain.main(["--device", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
                      "--n-layers", "1", "--seq-len", "32", "-b", "4", "--steps", "3", "-p",
                      "1", "--no-eval", "--fused-ce", "2", "--metrics-jsonl",
                      str(d / "m.jsonl"), "--hb-dir", str(d / "hb"), "--hb-interval", "0",
                      "--mfu", "--goodput", "--step-attr"])
    assert "=> goodput " in capsys.readouterr().out
    recs = _readers_agree(str(d / "m.jsonl"))
    steps = [r for r in recs if "ft_event" not in r]
    assert len(steps) == 3 and all(r["hfu"] > r["mfu"] > 0 for r in steps)   # fused-CE tax
    assert heartbeat.read_heartbeats(str(d / "hb"))[0]["step"] == 2
    assert _obs_report().main(["--metrics-jsonl", str(d / "m.jsonl"),
                               "--hb-dir", str(d / "hb")]) == 0
