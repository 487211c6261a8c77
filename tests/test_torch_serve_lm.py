"""The port's serving entry point, ``python -m
pytorch_distributed_tpu_torch.serving.serve_lm``, on the CPU at the JAX
script's default toy width."""

import json

import pytest
import torch

from pytorch_distributed_tpu.obs import metrics as jax_metrics
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger, _percentile
from pytorch_distributed_tpu_torch.serving import serve_lm

TOY = ["--device", "cpu", "--requests", "6", "--rate-rps", "400", "--max-new-tokens", "6"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's toy-size steps are thousands of tiny ops: under the
    parallel suite, intra-op threads only contend for the cores (six
    concurrent runs of this file took minutes with the default thread
    count, seconds with one), so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(capsys):
    return json.loads(capsys.readouterr().out)


def test_cpu_run_prints_the_summary_and_exits_zero(capsys, tmp_path):
    out = tmp_path / "summary.json"
    assert serve_lm.main(TOY + ["--no-watchdog", "--summary-json", str(out)]) == 0
    summary = _summary(capsys)
    assert summary == json.loads(out.read_text())
    assert summary["completed"] == 6 and summary["mode"] == "continuous"
    for key in ("tokens", "tokens_per_s", "wall_s", "preemptions", "defrags",
                "alloc_failures", "steps", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                "itl_p99_ms", "recompile_anomalies"):
        assert key in summary, key
    # eager on the CPU: no graph, one decode per iteration with live slots
    assert summary["decode_graph_captures"] == summary["decode_graph_replays"] == 0
    assert 0 < summary["decode_iterations"] <= summary["steps"]


def test_static_mode_emits_the_same_token_count(capsys):
    assert serve_lm.main(TOY) == 0
    cont = _summary(capsys)
    assert serve_lm.main(TOY + ["--mode", "static"]) == 0
    static = _summary(capsys)
    assert static["mode"] == "static" and static["completed"] == 6
    assert static["tokens"] == cont["tokens"]


def test_metrics_jsonl_carries_the_slo_fields(capsys, tmp_path):
    path = tmp_path / "serve.jsonl"
    assert serve_lm.main(TOY + ["--metrics-jsonl", str(path)]) == 0
    summary = _summary(capsys)
    records = [json.loads(line) for line in path.read_text().splitlines()]
    steps = [r for r in records if r.get("serving")]
    assert steps and len(steps) <= summary["steps"]
    for field in ("queue_depth", "active_seqs", "kv_occupancy_pct", "kv_frag_pct",
                  "preemptions", "requests_completed", "tokens_per_s", "ttft_p50_ms",
                  "ttft_p95_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms",
                  "step_time", "step_time_p50", "throughput"):
        assert field in steps[-1], field
    assert steps[-1]["requests_completed"] == 6


def test_quant_and_gamma_serve_every_request(capsys):
    """``--quant int8`` and ``--gamma 3`` (the default one-layer 16-wide
    draft) each serve the whole trace: every request to its cap, so the
    same token count as the plain run; speculation in no more steps."""
    assert serve_lm.main(TOY) == 0
    plain = _summary(capsys)
    assert serve_lm.main(TOY + ["--quant", "int8"]) == 0
    quant = _summary(capsys)
    assert serve_lm.main(TOY + ["--gamma", "3"]) == 0
    spec = _summary(capsys)
    for run in (quant, spec):
        assert run["completed"] == 6 and run["tokens"] == plain["tokens"]
    assert spec["steps"] <= plain["steps"]


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    assert serve_lm.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--requests", "2", "--device", "cuda"])


def _records(cls):
    got = []
    log = cls(None, flush_every=2)
    log.register(got.append)
    for step, t in enumerate((0.5, 0.1, 0.3)):
        log.log_step(step, t, n_items=4, extra={"x": float(step)})
    log.log_event("serve_preempt", step=2, rid=7)
    log.close()
    return [{k: v for k, v in r.items() if k != "t"} for r in got]


def test_metrics_copy_matches_the_jax_package():
    for vals in ([], [3.0], [1.0, 2.0, 5.0, 9.0], list(range(17))):
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert _percentile(vals, q) == jax_metrics._percentile(vals, q)
    assert _records(MetricsLogger) == _records(jax_metrics.MetricsLogger)
