"""The port's serving observability (``obs/reqtrace.py``, ``obs/watchdog.py``,
the engine's ``trace``/``watchdog``/``chaos`` hooks, ``serve_lm``'s SLO and
trace flags and ``tools/obs_trace.py``) against the JAX package's, on the CPU.

- The tracer copy, fed one seeded hook sequence, must give the JAX
  tracer's drained records, gauges, analyses and drop counts exactly.
- The port engine and the JAX engine, both traced and both under the same
  duck-typed chaos injector, on the same weights and load, at the toy size
  of ``tests/test_torch_serving.py``: the same tokens and the same
  ``reqtrace`` records, under a clock that stands still and one that
  advances 1 ms per read (the records hold every clock read the hooks
  make, so equal records mean the hooks read the clock where the JAX
  engine's do).
- The watchdogs fed one compile/capture sequence book the same
  ``recompile`` events; ``serve_lm`` with the SLO flags books the JAX
  script's ``alert`` events; ``obs_trace --json`` prints the JAX CLI's
  JSON for one file; the torch-free modules load without torch.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import quant as jq
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.obs import reqtrace as jrt
from pytorch_distributed_tpu.obs import watchdog as jwd
from pytorch_distributed_tpu.serving import loadgen as jload
from pytorch_distributed_tpu.serving.engine import ServingEngine as JaxEngine
from pytorch_distributed_tpu_torch.models.quant import quantize_state_dict
from pytorch_distributed_tpu_torch.obs import reqtrace as prt
from pytorch_distributed_tpu_torch.obs import watchdog as pwd
from pytorch_distributed_tpu_torch.obs.metrics import read_metrics
from pytorch_distributed_tpu_torch.serving import loadgen, serve_lm
from pytorch_distributed_tpu_torch.serving.engine import ServingEngine
from pytorch_distributed_tpu_torch.tools import obs_trace
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
# tests/test_torch_serving.py's engine shape, so a worker that runs both
# files compiles the JAX steps once
ENG = dict(max_batch=4, kv_blocks=13, block_size=8, blocks_per_seq=8,
           chunk_size=8, max_new_tokens=64)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's state dict of the same numbers)."""
    params = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4), jnp.int32))["params"]
    return params, lm_state_dict_from_jax(jax.device_get(params))


# ------------------------------------------------------------ the tracer


def _hook_calls(seed=0, n=40):
    """One seeded sequence of tracer hook calls: submits, admissions,
    chunked prefills, decodes with emits, preemptions with their requeue
    and redo prefill, defrags, completions, and periodic gauge reads and
    drains."""
    rng = np.random.RandomState(seed)
    calls, state, t = [], {}, 0.0
    submitted = 0
    while submitted < n or any(s != "done" for s in state.values()):
        t += float(rng.exponential(0.002))
        if submitted < n and rng.rand() < 0.3:
            calls.append(("on_submit", submitted, t, int(rng.randint(0, 3))))
            state[submitted] = "queued"
            submitted += 1
            continue
        live = [r for r, s in state.items() if s != "done"]
        if not live:
            continue
        rid = live[int(rng.randint(len(live)))]
        s = state[rid]
        if s in ("queued", "preempted"):
            calls.append(("on_admit", rid, t))
            marks = [t]
            for _ in range(int(rng.randint(1, 4))):
                t += float(rng.exponential(0.001))
                marks.append(t)
            calls.append(("on_prefill", rid, marks, s == "preempted"))
            calls.append(("on_emit", rid, t, s == "queued"))
            state[rid] = "running"
        elif rng.rand() < 0.12:
            calls.append(("on_preempt", rid, t))
            state[rid] = "preempted"
        elif rng.rand() < 0.2:
            calls.append(("on_complete", rid, t, int(rng.randint(2, 30)),
                          int(rng.randint(0, 3))))
            state[rid] = "done"
        else:
            t1 = t + float(rng.exponential(0.001))
            calls.append(("on_decode", rid, t, t1, int(rng.randint(1, 4))))
            calls.append(("on_emit", rid, t1, False))
            t = t1
        if rng.rand() < 0.05:
            calls.append(("on_defrag", t, t + 0.0005))
        if rng.rand() < 0.1:
            calls.append(("step_fields",))
        if rng.rand() < 0.04:
            calls.append(("drain",))
    calls.append(("step_fields",))
    calls.append(("drain",))
    return calls


def _replay(mod, calls, **kw):
    tr = mod.ReqTracer(**kw)
    out = []
    for name, *a in calls:
        got = getattr(tr, name)(*a)
        if name in ("step_fields", "drain"):
            out.append((name, got))
        elif name == "on_submit":
            out.append((name, got.to_wire()))
    counters = {k: getattr(tr, k) for k in ("completed", "violations", "sampled_kept",
                                            "spans_dropped", "records_dropped",
                                            "redo_prefills")}
    return out, counters


@pytest.mark.parametrize("kw", [
    dict(slo_ms=8.0, sample=0.3),
    dict(slo_ms=5.0, sample=1.0, max_spans=60, max_pending=6, max_intervals=4, window=8),
    dict(slo_ms=None, sample=0.0)], ids=["sampled", "bounded", "unsampled"])
def test_tracer_matches_jax_on_one_hook_sequence(kw):
    calls = _hook_calls()
    want, want_n = _replay(jrt, calls, **kw)
    got, got_n = _replay(prt, calls, **kw)
    assert got == want and got_n == want_n
    if "max_spans" in kw:
        assert got_n["spans_dropped"] > 0 and got_n["records_dropped"] > 0
    records = [r for name, d in got if name == "drain" for r in d]
    assert records
    for fn in ("tail_attribution", "attribution_summary", "chrome_events"):
        assert getattr(prt, fn)(records) == getattr(jrt, fn)(records), fn
    tail = prt.tail_attribution(records)
    assert prt.format_tail_line(tail) == jrt.format_tail_line(tail)
    ctx = prt.TraceContext.from_wire(json.loads(records[0]["ctx"]))
    assert ctx.to_wire() == jrt.TraceContext.from_wire(json.loads(records[0]["ctx"])).to_wire()


# ------------------------------------------------------------ the engines


class _Storm:
    """Duck-typed chaos injector for either engine: from step 3, evict the
    scheduler's preferred victim every 3 steps while two lanes are live."""

    def __init__(self):
        self.steps = []

    def on_step(self, eng, step):
        self.steps.append(step)
        if step >= 3 and step % 3 == 0 and len(eng.sched.active) > 1:
            victim = eng.sched.pick_victim()
            if victim is not None:
                eng._preempt(victim)


def _clock(per_read):
    t = [0.0]

    def time_fn():
        t[0] += per_read
        return t[0]

    return time_fn, lambda s: t.__setitem__(0, t[0] + max(s, 1e-3))


def _traced_run(cls, params, per_read, n=12, **kw):
    time_fn, sleep_fn = _clock(per_read)
    mod = loadgen if cls is ServingEngine else jload
    load = [(0.0, req) for _, req in mod.generate_load(mod.LoadConfig(
        n_requests=n, profile="mixed", vocab_size=CFG["vocab_size"], seed=4))]
    tracer = (prt if cls is ServingEngine else jrt).ReqTracer(slo_ms=20.0, sample=0.5)
    chaos = _Storm()
    args = dict(CFG, **ENG, time_fn=time_fn, sleep_fn=sleep_fn, seed=0, trace=tracer,
                chaos=chaos, **kw)
    if cls is ServingEngine:
        args["device"] = "cpu"
    eng = cls(params, **args)
    s = eng.run(load)
    return eng, s, tracer.drain(), chaos.steps


@pytest.mark.parametrize("per_read", [0.0, 1e-3], ids=["still_clock", "1ms_per_read"])
def test_traced_engine_matches_jax_traced_engine(weights, per_read):
    jeng, js, jrecs, jsteps = _traced_run(JaxEngine, weights[0], per_read)
    peng, ps, precs, psteps = _traced_run(ServingEngine, weights[1], per_read)
    assert ps["preemptions"] > 0 and ps["preemptions"] == js["preemptions"]
    assert psteps == jsteps == list(range(1, ps["steps"] + 1))
    assert ({r.rid: r.generated for r in peng.finished}
            == {r.rid: r.generated for r in jeng.finished})
    assert len(precs) == 12 and precs == jrecs
    assert sum(r["preemptions"] for r in precs) == ps["preemptions"]


@pytest.mark.parametrize("variant", ["speculative", "int8"])
def test_traced_variants_match_jax_records(weights, variant):
    """The hooks fire where the JAX engine's do under speculation (gamma 3,
    a 16-wide one-layer draft) and int8 weights, on the 1 ms-per-read
    clock.  Requests stop at their caps, so the schedule (and with it
    every record) ignores token values; the speculative tokens are the
    JAX engine's too."""
    params, sd = weights
    if variant == "speculative":
        jdraft = jax.tree_util.tree_map(np.asarray, jax.jit(JaxLM(
            vocab_size=CFG["vocab_size"], d_model=16, n_heads=CFG["n_heads"], n_layers=1).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"])
        jkw = dict(gamma=3, draft_params=jdraft)
        pkw = dict(gamma=3, draft_params=lm_state_dict_from_jax(jdraft))
    else:
        params, sd = jq.quantize_lm_params(params), quantize_state_dict(sd)
        jkw = pkw = dict(quant="int8")
    jeng, js, jrecs, _ = _traced_run(JaxEngine, params, 1e-3, n=6, **jkw)
    peng, ps, precs, _ = _traced_run(ServingEngine, sd, 1e-3, n=6, **pkw)
    assert len(precs) == 6 and precs == jrecs and ps["steps"] == js["steps"]
    if variant == "speculative":
        assert ({r.rid: r.generated for r in peng.finished}
                == {r.rid: r.generated for r in jeng.finished})


def test_tracing_leaves_tokens_alone_and_redo_spans_count_preemptions(weights):
    time_fn, sleep_fn = _clock(0.0)
    plain = ServingEngine(weights[1], **CFG, **ENG, time_fn=time_fn, sleep_fn=sleep_fn,
                          chaos=_Storm(), device="cpu")
    load = [(0.0, r) for _, r in loadgen.generate_load(loadgen.LoadConfig(
        n_requests=12, profile="mixed", vocab_size=CFG["vocab_size"], seed=4))]
    plain.run(load)
    traced, s, recs, _ = _traced_run(ServingEngine, weights[1], 0.0)
    assert ({r.rid: r.generated for r in traced.finished}
            == {r.rid: r.generated for r in plain.finished})
    assert traced.trace.redo_prefills == s["preemptions"] > 0
    bumped = [r for r in recs if r["preemptions"] > 0 and r.get("spans")]
    assert bumped
    for r in bumped:
        kinds = {sp[0] for sp in json.loads(r["spans"])}
        assert {"preempt", "redo_prefill", "requeue_wait"} <= kinds
    for r in recs:   # the components reconcile with the engine's TTFT
        waits = (r["queue_wait_ms"] + r["prefill_ms"] + r["redo_wait_ms"]
                 + r["defrag_wait_ms"] + r["other_wait_ms"])
        assert waits == pytest.approx(r["ttft_ms"], abs=0.05)
    assert (sorted(round(r["ttft_ms"], 3) for r in recs)
            == sorted(round(t * 1e3, 3) for t in traced.ttft_samples))


# ------------------------------------------------------------ the watchdog


class _Events:
    def __init__(self):
        self.events = []

    def log_event(self, kind, **fields):
        self.events.append((kind, fields))


def test_watchdog_books_the_jax_watchdogs_recompile_events():
    """The same sequence, as JAX compile events and as port captures:
    warm-ups, a second compile under one label, one outside any watch."""
    seq = [("serve_decode", 0, 0.5), ("serve_prefill", 1, 0.2), ("serve_decode", 7, 0.4),
           (None, None, 0.1), ("serve_decode", 9, 0.3), ("serve_prefill", 9, 0.1)]
    booked = []
    for mod, fire in ((jwd, lambda wd, d: wd._on_event(jwd.BACKEND_COMPILE_EVENT, d)),
                      (pwd, lambda wd, d: wd.on_capture(d))):
        obs = _Events()
        wd = mod.RecompileWatchdog(obs=obs)
        wd._installed = True   # the JAX listener stays unregistered: fed by hand
        with contextlib.redirect_stdout(io.StringIO()):
            for label, step, dur in seq:
                with (wd.watch(label, step=step) if label else contextlib.nullcontext()):
                    fire(wd, dur)
        booked.append((obs.events, wd.anomalies, wd.compiles))
    assert booked[1] == booked[0]
    assert [e[1]["compile_index"] for e in booked[1][0]] == [2, 3, 2]


def test_engine_watchdog_books_no_capture_on_the_cpu(weights):
    wd = pwd.RecompileWatchdog(obs=_Events()).install()
    time_fn, sleep_fn = _clock(0.0)
    eng = ServingEngine(weights[1], **CFG, **ENG, time_fn=time_fn, sleep_fn=sleep_fn,
                        watchdog=wd, device="cpu")
    eng.run([(0.0, r) for _, r in loadgen.generate_load(loadgen.LoadConfig(
        n_requests=4, vocab_size=CFG["vocab_size"], seed=1))])
    assert eng.graph_captures == 0 and wd.compiles == {} and wd.anomalies == []


# ------------------------------------------------------------ serve_lm, obs_trace


TOY = ["--requests", "6", "--rate-rps", "1e12", "--max-new-tokens", "6", "--max-batch", "4",
       "--kv-blocks", "13", "--block-size", "8", "--blocks-per-seq", "8", "--chunk-size", "8"]


def _alerts(path):
    return [{k: e.get(k) for k in ("alert", "rule", "severity", "step", "threshold")}
            for e in read_metrics(path) if e.get("ft_event") == "alert"]


def test_serve_lm_slo_flags_book_the_jax_scripts_alerts(tmp_path, capsys):
    """Every request arrives within a picosecond, before the engine's
    first wait ends, so both engines admit them together and the schedule
    (and with it the KV occupancy) is the same whatever the wall clock;
    SLO ceilings under any TTFT and occupancy make the alerts depend on
    the schedule alone."""
    flags = TOY + ["--slo-ttft-ms", "1e-6", "--slo-kv-pct", "1e-6", "--req-trace"]
    jax_serve = _load_script("serve_lm")
    assert jax_serve.main(flags + ["--metrics-jsonl", str(tmp_path / "j.jsonl")]) == 0
    assert serve_lm.main(flags + ["--device", "cpu",
                                  "--metrics-jsonl", str(tmp_path / "p.jsonl")]) == 0
    capsys.readouterr()
    want, got = _alerts(tmp_path / "j.jsonl"), _alerts(tmp_path / "p.jsonl")
    assert got == want
    assert {a["rule"] for a in got} == {"ttft_p99", "kv_occupancy"}

    # obs_trace --json on the port's file prints what the JAX CLI prints
    assert obs_trace.main(["--metrics-jsonl", str(tmp_path / "p.jsonl"), "--json"]) == 0
    ours = capsys.readouterr().out
    assert _load_script("obs_trace").main(
        ["--metrics-jsonl", str(tmp_path / "p.jsonl"), "--json"]) == 0
    assert json.loads(ours) == json.loads(capsys.readouterr().out)
    assert json.loads(ours)["requests"] == 6


def test_serve_lm_summary_counts_traces_and_the_watchdog(capsys):
    assert serve_lm.main(TOY + ["--device", "cpu", "--req-trace", "--trace-sample", "1.0"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert (s["traces_completed"], s["trace_violations"], s["trace_spans_dropped"]) == (6, 0, 0)
    assert s["recompile_anomalies"] == 0 and s["decode_graph_captures"] == 0
    assert serve_lm.main(TOY + ["--device", "cpu", "--no-watchdog"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["recompile_anomalies"] is None and "traces_completed" not in s


def test_obs_trace_selftest_and_fleet_modules_load_without_torch():
    code = (
        "import sys\n"
        "import pytorch_distributed_tpu_torch.obs.reqtrace\n"
        "import pytorch_distributed_tpu_torch.obs.watchdog\n"
        "import pytorch_distributed_tpu_torch.ft.elastic\n"
        "import pytorch_distributed_tpu_torch.serving.router\n"
        "from pytorch_distributed_tpu_torch.serving.replica import SimEngineBackend\n"
        "import pytorch_distributed_tpu_torch.tools.serve_fleet\n"
        "import pytorch_distributed_tpu_torch.tools.chaoskit\n"
        "from pytorch_distributed_tpu_torch.tools import obs_trace\n"
        "assert obs_trace.main(['--selftest']) == 0\n"
        "bad = [m for m in ('torch', 'jax', 'numpy', 'pytorch_distributed_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('torch-free')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "obs_trace selftest: OK" in res.stdout and "torch-free" in res.stdout
