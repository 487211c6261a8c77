"""The port's metrics-stream modules (``pytorch_distributed_tpu_torch/obs``,
``utils/telemetry.py``) against the JAX package's on the same inputs.

- The analytic FLOPs models: ``image_step_cost`` for every arch of the
  JAX ResNet and ViT tables, ``lm_step_cost`` for three LM shapes (fused
  CE and not), ``MFUReporter.fields``: equal, exactly.
- ``counted_step_flops`` (``FlopCounterMode``, the twin of the JAX
  ``xla_step_flops``) on a tiny ResNet-18 (b8, 32 px) and a tiny LM within
  +-10% of the analytic count, the JAX acceptance of
  ``tests/test_efficiency.py``.
- The stdlib copies (goodput, heartbeat, stepattr, ``read_metrics``) give
  the JAX modules' answers on the same seeded records.
- The card tables, the telemetry sampler and the profiler window on the
  CPU, and their refusals.
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.obs import flops as jflops
from pytorch_distributed_tpu.obs import goodput as jgoodput
from pytorch_distributed_tpu.obs import heartbeat as jheartbeat
from pytorch_distributed_tpu.obs import metrics as jmetrics
from pytorch_distributed_tpu.obs import stepattr as jstepattr
from pytorch_distributed_tpu_torch import models
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.obs import flops, goodput, heartbeat, metrics, stepattr
from pytorch_distributed_tpu_torch.obs.trace import ProfileWindow, capture, parse_span, scope
from pytorch_distributed_tpu_torch.train.lm import make_lm_train_step
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.utils import telemetry

ARCHS = sorted(jflops._RESNET_CFGS) + sorted(jflops._VIT_CFGS)
LM_SHAPES = [(32000, 1024, 12, 4, 4096), (64, 32, 2, 8, 16), (50257, 768, 6, 2, 1024)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ analytic FLOPs

@pytest.mark.parametrize("arch", ARCHS)
def test_image_step_cost_equals_jax(arch):
    for batch, side, classes in ((256, 224, 1000), (8, 32, 8)):
        got = flops.image_step_cost(arch, batch, side, classes)
        want = jflops.image_step_cost(arch, batch, side, classes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = flops.MFUReporter(got, n_devices=4, peak_per_chip=989e12)
    want = jflops.MFUReporter(want, n_devices=4, peak_per_chip=989e12)
    assert got.fields(0.2345) == want.fields(0.2345)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_ce"])
@pytest.mark.parametrize("shape", LM_SHAPES, ids=["lm184m", "tiny", "gpt2_6l"])
def test_lm_step_cost_equals_jax(shape, fused):
    V, D, L, B, S = shape
    got = flops.lm_step_cost(V, D, L, B, S, fused_ce=fused)
    want = jflops.lm_step_cost(V, D, L, B, S, fused_ce=fused)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    model = TransformerLM(vocab_size=V, d_model=D, n_heads=4, n_layers=L, device="meta")
    chunks = 4 if fused else 0
    assert flops.lm_step_cost_for(model, B, S, chunks) == got
    assert (flops.MFUReporter(got, 2, 50e9).fields(0.1)
            == jflops.MFUReporter(want, 2, 50e9).fields(0.1))
    if fused:
        assert got.hardware_flops > got.model_flops
    assert (flops.lm_train_mem_peak(V, D, L, 4, B, S).peak_bytes
            == jflops.lm_train_mem_peak(V, D, L, 4, B, S).peak_bytes)


def test_counted_step_flops_within_ten_percent_of_the_analytic_count():
    """FlopCounterMode over one CPU train step (convolutions over valid
    taps) against the analytic model: ResNet-18 b8 32 px (ratio 0.908:
    the count leaves out the first conv's unneeded dgrad and the SGD
    update's elementwise work) and an LM (0.996)."""
    B, IM, NC = 8, 32, 8
    net = models.create_model("resnet18", num_classes=NC, device="cpu")
    net.init_weights(torch.Generator().manual_seed(0))
    batch = {"images": torch.zeros(B, IM, IM, 3), "labels": torch.zeros(B, dtype=torch.long),
             "weights": torch.ones(B)}
    counted = flops.counted_step_flops(make_train_step(net, sgd(net.parameters())), batch, 0.1)
    cost = flops.image_step_cost("resnet18", B, IM, NC)
    assert cost.params == sum(p.numel() for p in net.parameters())
    assert 0.9 <= counted / cost.model_flops <= 1.1, counted / cost.model_flops

    V, D, H, L, B, S = 64, 64, 4, 2, 8, 32
    lm = TransformerLM(vocab_size=V, d_model=D, n_heads=H, n_layers=L, device="cpu")
    lm.init_weights(torch.Generator().manual_seed(0))
    step = make_lm_train_step(lm, sgd(lm.parameters()))
    counted = flops.counted_step_flops(step, torch.zeros(B, S, dtype=torch.long), 0.1)
    cost = flops.lm_step_cost_for(lm, B, S)
    assert cost.params == sum(p.numel() for p in lm.parameters())
    assert 0.9 <= counted / cost.model_flops <= 1.1, counted / cost.model_flops
    with pytest.raises(ValueError, match="CPU path"):
        flops.counted_step_flops(lambda b: b, {"x": _FakeCuda(torch.zeros(2))})


class _FakeCuda(torch.Tensor):
    """A tensor that says it lives on a card (there is none here)."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_subclass(cls, t)

    @property
    def is_cuda(self):
        return True


def test_card_tables_and_overrides(monkeypatch):
    for env in ("PTD_TPU_PEAK_FLOPS", "PTD_TPU_HBM_BYTES", "PTD_TPU_HBM_BW",
                "PTD_TPU_LINK_BYTES"):
        monkeypatch.delenv(env, raising=False)
    h100 = "nvidia h100 80gb hbm3"
    assert flops.chip_peak_flops(h100) == 989e12
    assert flops.chip_hbm_bw(h100) == 3.35e12
    assert flops.chip_link_bytes(h100) == 900e9
    assert flops.chip_hbm_bytes(h100) == 80e9
    # The CPU keeps the JAX package's placeholders.
    assert flops.device_peak_flops("cpu") == jflops.CPU_FALLBACK_PEAK == 50e9
    assert flops.device_hbm_bytes("cpu") == jflops.CPU_FALLBACK_HBM
    assert flops.chip_hbm_bw("") == jflops.CPU_FALLBACK_HBM_BW
    with pytest.raises(ValueError, match="PTD_TPU_PEAK_FLOPS"):
        flops.chip_peak_flops("nvidia a100-sxm4-80gb")
    monkeypatch.setenv("PTD_TPU_PEAK_FLOPS", "123e12")
    assert flops.device_peak_flops("cpu") == flops.chip_peak_flops("anything") == 123e12


# -------------------------------------------------------------- stdlib copies

def _records(seed):
    """A seeded metrics stream: steps with jitter, a stall, events of each
    kind the goodput ledger books, attribution fields, a phase event."""
    rng = random.Random(seed)
    recs, t = [], 1000.0
    for s in range(40):
        st = 0.1 + 0.02 * rng.random()
        t += st + (3.0 if s == 17 else 0.0)
        dw, hs = 5 * rng.random(), rng.random()
        dev = 1e3 * st - dw - hs - rng.random()
        recs.append({"step": s, "t": t, "process": 0, "step_time": st, "loss": 5 - 0.1 * s,
                     "attr_compute_ms": dev, "attr_exposed_comm_ms": 0.0,
                     "attr_host_sync_ms": hs, "attr_data_wait_ms": dw,
                     "attr_other_ms": 1e3 * st - dev - hs - dw, "attr_device_ms": dev,
                     "attr_comm_ms": 0.0, "attr_recon_err_ms": 0.0,
                     "data_wait_share": 100 * dw / (1e3 * st)})
    recs.append({"ft_event": "skip", "step": 5, "t": recs[5]["t"] + 0.01, "process": 0})
    recs.append({"ft_event": "rollback", "step": 12, "restored_step": 9, "t": recs[12]["t"]})
    recs.append({"ft_event": "preempt", "t": recs[25]["t"] + 0.001})
    recs.append({"ft_event": "recompile", "duration_s": 0.7, "t": recs[30]["t"]})
    recs.append({"ft_event": "alert", "t": recs[31]["t"]})
    prof = stepattr.phase_profile({"forward": 1e12, "backward": 2e12, "update": 1e9},
                                  {"forward": 1e9, "backward": 2e9, "update": 3e8},
                                  peak_flops=989e12, hbm_bw=3.35e12, link_bw=900e9)
    recs.append({"ft_event": "stepattr_phases", "t": recs[0]["t"],
                 **stepattr.phase_event_fields(prof)})
    rng.shuffle(recs)
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_stdlib_copies_answer_as_the_jax_modules(tmp_path, seed):
    recs = _records(seed)
    path = tmp_path / "m.jsonl"
    with metrics.MetricsLogger(str(path), flush_every=7) as log:
        for r in recs:
            log.log_step(r.get("step", 0), r.get("step_time", 0.1), extra=r)
    assert metrics.read_metrics(str(path)) == jmetrics.read_metrics(str(path))
    assert set(jmetrics.REQUIRED_FIELDS) <= set(metrics.read_metrics(str(path))[0])

    got, want = goodput.compute_goodput(recs), jgoodput.compute_goodput(recs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.counts["stall"] >= 1 and got.counts["preempt_gap"] == 1
    assert goodput.summarize_goodput(recs) == jgoodput.summarize_goodput(recs)
    mine, theirs = goodput.GoodputTracker(), jgoodput.GoodputTracker()
    for r in recs:
        mine(r)
        theirs(r)
    assert mine.format_summary() == theirs.format_summary()

    summary = stepattr.summarize(recs)
    assert summary == jstepattr.summarize(recs)
    prof = stepattr.phase_event(recs)
    assert prof == jstepattr.phase_event(recs)
    assert stepattr.roofline(summary, prof) == jstepattr.roofline(summary, prof)
    assert stepattr.format_summary_line(summary) == jstepattr.format_summary_line(summary)
    assert (stepattr.chrome_counter_events(recs) == jstepattr.chrome_counter_events(recs))
    assert (stepattr.split_step_bytes(1e10, 1e7) == jstepattr.split_step_bytes(1e10, 1e7))
    sa, jsa = stepattr.StepAttr(link_bytes_per_s=900e9), jstepattr.StepAttr(
        link_bytes_per_s=900e9)
    for obj in (sa, jsa):
        obj.set_comm_bytes(2e8)
        obj._t_data, obj._t_device, obj._t_sync = 0.004, 0.2, 0.001
    assert sa.fields(0.21) == jsa.fields(0.21)


def test_heartbeats_read_alike(tmp_path):
    rng = random.Random(3)
    writers = [heartbeat.HeartbeatWriter(str(tmp_path), pid, interval_s=0.0, world=4)
               for pid in range(4)]
    for step in range(6):
        for w in writers[:3] if step > 2 else writers:
            w.beat(step, step_time_ema=0.1 + 0.3 * (w.process_index == 1),
                   mem_bytes=rng.randrange(1 << 30), data_wait_ms=rng.random() * 200)
    writers[2].close(9, step_time_ema=0.1)
    with open(os.path.join(tmp_path, "heartbeat-00003.jsonl"), "a") as f:
        f.write('{"pid": 3, "step": ')     # a torn final line
    got = heartbeat.read_heartbeats(str(tmp_path))
    assert got == jheartbeat.read_heartbeats(str(tmp_path))
    assert sorted(got) == [0, 1, 2, 3] and got[2]["step"] == 9
    now = max(b["t"] for b in got.values()) + 100.0
    for kw in (dict(), dict(now=now), dict(max_step_lag=1, now=now - 99.0)):
        assert heartbeat.find_stragglers(got, **kw) == jheartbeat.find_stragglers(got, **kw)
    assert heartbeat.fleet_rollup(got, now) == jheartbeat.fleet_rollup(got, now)
    assert heartbeat.read_heartbeats(str(tmp_path), min_epoch=1) == {}
    assert heartbeat.sample_process_memory() > 0   # the RSS here


# ------------------------------------------------- telemetry and the profiler

def test_telemetry_on_the_cpu_and_without_a_card(tmp_path):
    (row,) = telemetry.sample_devices("cpu")
    ts, index, limit, in_use, peak = row
    assert index == 0 and limit == 0 and peak >= in_use > 0 and ts > 0
    path = str(tmp_path / "t.csv")
    sampler = telemetry.TelemetrySampler(path, interval_s=0.01, device="cpu").start()
    sampler.stop()
    rows = [line.split(",") for line in open(path).read().splitlines()]
    assert len(rows) >= 2 and all(len(r) == 5 and r[2] == "0" for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            telemetry.TelemetrySampler(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            telemetry.sample_devices()


def test_profile_window_segments_on_the_cpu(tmp_path):
    assert parse_span("5") == (5, 6) and parse_span("10:20") == (10, 20)
    assert parse_span(None) is None
    with pytest.raises(ValueError, match="bad span"):
        parse_span("4:2")
    win = ProfileWindow(str(tmp_path / "p"), epochs="1:3", steps="2:4", device="cpu")
    for epoch in range(4):
        win.epoch_begin(epoch)
        for step in range(6):
            win.step_begin(epoch, step)
            with scope("train_step"):
                torch.ones(4).sum()
        win.epoch_end()
    assert len(win.paths) == 2    # epochs 1 and 2, steps 2-3 of each
    for path in win.paths:
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert "train_step" in names
    whole = ProfileWindow(str(tmp_path / "q"), start_epoch=1)
    whole.epoch_begin(0)
    assert not whole.epoch_end()
    whole.epoch_begin(1)
    assert whole.epoch_end() and len(whole.paths) == 1
    with capture(str(tmp_path / "c")):
        np.ones(2)
    assert len(os.listdir(tmp_path / "c")) == 1
