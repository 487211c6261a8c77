"""The port's ``bench.py`` twin and its timing harness on the CPU, at toy
size: the JSON line's contract, no number when the fused variant fails, the
card by default, and ``utils/benchstep.py`` against the JAX package's."""

import json
import math

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.utils import benchstep as jax_benchstep
from pytorch_distributed_tpu_torch.tools import bench
from pytorch_distributed_tpu_torch.utils.benchstep import looks_like_oom, measure_train_step

TOY = ["--device", "cpu", "-b", "2", "--image-size", "32", "--iters", "1", "--warmup", "0"]
KEYS = {"metric", "value", "unit", "vs_baseline", "config", "unfused_img_s", "fused_img_s",
        "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_prints_one_json_line_with_bench_py_keys(capsys):
    assert bench.main(TOY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "resnet50_train_images_per_sec_per_chip"
    assert rec["unit"] == "images/sec/chip" and rec["device"] == "cpu"
    assert rec["value"] == max(rec["unfused_img_s"], rec["fused_img_s"]) > 0
    assert rec["config"] == ("fused_convbn" if rec["fused_img_s"] > rec["unfused_img_s"]
                             else "baseline")
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (1281167 / 1186.5 / 4), abs=2e-3)


def test_a_failed_fused_variant_exits_without_a_number(monkeypatch, capsys):
    def fake(fused, *args):
        if fused:
            raise RuntimeError("fused kernel failed")
        return 100.0

    monkeypatch.setattr(bench, "measure", fake)
    with pytest.raises(RuntimeError, match="fused kernel failed"):
        bench.main(TOY)
    assert capsys.readouterr().out == ""


def test_bench_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    assert bench.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["-b", "2"])


def test_measure_train_step_syncs_counts_and_checks_the_loss():
    calls = []

    def step(batch, lr):
        calls.append(lr)
        return {"loss": torch.tensor(float(len(calls)))}

    dt, metrics = measure_train_step(step, None, 0.5, iters=4, warmup=2)
    assert len(calls) == 6 and float(metrics["loss"]) == 6.0 and dt >= 0.0
    with pytest.raises(AssertionError):
        measure_train_step(lambda b, lr: {"loss": torch.tensor(math.nan)}, None, 0.1, 2, 0)


@pytest.mark.parametrize("err", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"),
    MemoryError("Ran out of memory in memory space vmem"),
    ValueError("shapes (3,) and (4,) not aligned"),
])
def test_looks_like_oom_agrees_with_jax_and_knows_torch(err):
    want = not isinstance(err, ValueError)
    assert looks_like_oom(err) is want
    if not isinstance(err, torch.cuda.OutOfMemoryError):
        assert jax_benchstep.looks_like_oom(err) is want
    assert looks_like_oom(torch.cuda.OutOfMemoryError("OutOfMemoryError"))


def test_synthetic_batch_is_bench_py_s():
    """The same numpy draws as bench.py: images from default_rng(0).normal,
    then labels from the same generator."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 4, 4, 3))
    labels = rng.integers(0, 1000, size=2)
    got = bench.synthetic_batch(2, 4, torch.device("cpu"))
    assert torch.equal(got["images"], torch.from_numpy(images).to(torch.bfloat16))
    assert got["labels"].tolist() == labels.tolist() and got["weights"].tolist() == [1.0, 1.0]
