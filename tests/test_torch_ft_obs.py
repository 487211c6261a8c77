"""The port's death paths and live plane against the JAX package's, module
by module, on the CPU: the same seeded inputs into both.

- ``obs/flightrec.py``: the same event sequence gives equal snapshots
  (apart from times, the pid and the memory sample); ``find_dumps``; the
  signal dump chaining to the preemption guard; the hang watchdog firing
  once per stall and re-arming, on injected elapsed times.
- ``tools/postmortem.py`` on the JAX repo's fixture gives the JAX test's
  answers and the JAX report; its ``--selftest`` and ``tools/obs_live.py
  --selftest`` pass in a process of their own.
- ``obs/alerts.py``: both engines fed the JAX tests' records (a temporary
  LKG, an explicit ``now``) book the same history; the port's default rules
  age no LKG, so the two JAX cases that depend on today's date book nothing
  of it.
- ``obs/export.py``: the same record renders the same samples, and a real
  socket serves ``/healthz`` 503 before the first record and 200 after.
- ``utils/preempt.py``, ``ft/chaos.py`` and ``obs/timeline.py``: the
  parsers, injectors and clock offsets give the JAX answers.

Every comparison is exact: the modules are copies of the same code.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ft import chaos as jchaos
from pytorch_distributed_tpu.obs import alerts as jalerts
from pytorch_distributed_tpu.obs import export as jexport
from pytorch_distributed_tpu.obs import flightrec as jflightrec
from pytorch_distributed_tpu.obs import timeline as jtimeline
from pytorch_distributed_tpu.utils import preempt as jpreempt
from pytorch_distributed_tpu_torch.ft import chaos
from pytorch_distributed_tpu_torch.obs import alerts, export, flightrec, timeline
from pytorch_distributed_tpu_torch.tools import postmortem
from pytorch_distributed_tpu_torch.utils import preempt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "postmortem")
# Snapshot fields that are the process's or the clock's, not the ring's.
VOLATILE = {"t", "t_dump", "pid", "mem_bytes"}


def _jax_postmortem():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import postmortem as jpostmortem
    return jpostmortem


def _stable(snap):
    """A snapshot without the clock, pid and memory readings."""
    out = {k: v for k, v in snap.items() if k not in VOLATILE}
    out["events"] = [{k: v for k, v in e.items() if k != "t"} for e in snap["events"]]
    if out["last_collective"]:
        out["last_collective"] = {k: v for k, v in out["last_collective"].items() if k != "t"}
    out["in_step"] = None if snap["in_step"] is None else snap["in_step"]["step"]
    return out


def _drive(rec):
    """One seeded sequence through a recorder: steps with collective
    regions and fixed step times, ft events, membership, a heartbeat, an
    open step at the end; more events than the ring holds."""
    rng = np.random.default_rng(5)
    rec.set_membership(2, 0)
    for s in range(7):
        rec.step_begin(s)
        rec.coll_enter(s, kind="all-reduce" if s % 2 else None, bytes=float(rng.integers(1, 9)))
        rec.coll_exit(s)
        rec.step_end(s, dt=float(rng.uniform(0.1, 0.2)))
        if s == 3:
            rec.event("checkpoint", s, epoch=0, step_in_epoch=4)
            rec.record("skip", s, reason="nonfinite")
    rec.heartbeat({"step": 6, "last_ft": "skip"})
    rec.step_begin(7)
    rec.coll_enter(7, name="all-reduce.1")


@pytest.mark.parametrize("capacity", [8, 64])
def test_flight_recorders_snapshot_alike(tmp_path, capacity):
    got = flightrec.FlightRecorder(str(tmp_path / "port"), rank=1, capacity=capacity)
    want = jflightrec.FlightRecorder(str(tmp_path / "jax"), rank=1, capacity=capacity)
    for rec in (got, want):
        _drive(rec)
    g, w = got.snapshot("hang"), want.snapshot("hang")
    assert _stable(g) == _stable(w)
    assert g["events_dropped"] == (max(0, g["events_total"] - capacity))
    assert got.step_time_quantile(0.95) == want.step_time_quantile(0.95)
    # The dumps are the same JSON (apart from the volatile fields) and each
    # package finds the other's.
    got.dump("hang")
    want.dump("hang")
    for a, b in ((tmp_path / "port", tmp_path / "jax"), (tmp_path / "jax", tmp_path / "port")):
        assert flightrec.find_dumps(str(a)).keys() == jflightrec.find_dumps(str(b)).keys() == {1}
    docs = [json.loads(open(flightrec.dump_path(str(tmp_path / d), 1)).read())
            for d in ("port", "jax")]
    assert _stable(docs[0]) == _stable(docs[1])


def test_find_dumps_filters_like_jax(tmp_path):
    for name in ("flightrec_rank7.json", "flightrec_rank12.json", "flightrec_rankX.json",
                 "flightrec_rank3.json.tmp.5", "heartbeat-00001.jsonl"):
        (tmp_path / name).write_text("{}")
    assert flightrec.find_dumps(str(tmp_path)) == jflightrec.find_dumps(str(tmp_path))
    assert sorted(flightrec.find_dumps(str(tmp_path))) == [7, 12]
    assert flightrec.find_dumps(str(tmp_path / "missing")) == {}


def test_signal_dump_runs_first_then_chains_to_the_guard(tmp_path):
    """The trainers' order: the guard installed first, the signal dump on
    top of it; one signal writes the dump with the signal's reason and
    still sets the guard's flag; uninstalling restores the handlers."""
    before = signal.getsignal(signal.SIGUSR1)
    rec = flightrec.FlightRecorder(str(tmp_path), rank=0)
    guard = preempt.PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    dump = flightrec.FlightSignalDump(rec, signals=(signal.SIGUSR1,)).install()
    try:
        rec.step_begin(3)
        os.kill(os.getpid(), signal.SIGUSR1)
        doc = json.loads(open(flightrec.dump_path(str(tmp_path), 0)).read())
        assert doc["reason"] == f"signal:{int(signal.SIGUSR1)}"
        assert doc["events"][-1]["kind"] == "signal" and doc["in_step"]["step"] == 3
        assert guard.triggered
    finally:
        dump.uninstall()
        guard.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


def test_hang_watchdogs_fire_once_per_stall_and_rearm(tmp_path):
    """Injected (step, elapsed) readings, no sleeping: both watchdogs fire
    on the same readings, latch on a stalled step, re-arm on the next, and
    move to k x p95 once five steps completed."""
    readings = [(2, 0.1), (2, 1.0), (2, 5.0), (3, 0.4), (3, 1.0), (3, 9.0), (4, 0.2),
                (5, 2.1), (5, 2.5)]
    fired = {}
    for name, mod in (("port", flightrec), ("jax", jflightrec)):
        rec = mod.FlightRecorder(str(tmp_path / name))
        wd = mod.HangWatchdog(rec, timeout=0.5, k=4.0)
        rec.step_begin(2)
        rec.coll_enter(2, kind="all-gather")
        out = [wd.check(now_elapsed=r) for r in readings[:6]]
        for s in range(6):
            rec.step_begin(10 + s)
            rec.step_end(10 + s, dt=0.5)
        out += [wd.threshold()] + [wd.check(now_elapsed=r) for r in readings[6:]]
        fired[name] = (out, wd.hangs)
        doc = json.loads(open(mod.dump_path(str(tmp_path / name), 0)).read())
        assert doc["reason"] == "hang"
        assert [e["collective"] for e in doc["events"] if e["kind"] == "hang"] == \
            ["all-gather"] * 3
    assert fired["port"] == fired["jax"]
    assert fired["port"] == ([False, True, False, False, True, False, 2.0, False, True,
                              False], 3)


def test_postmortem_on_the_fixture_gives_the_jax_answers():
    """``tests/data/postmortem`` (rank 0 blocked in the step-5 all-reduce,
    rank 1 one collective behind with its clock 2 s ahead): the JAX test's
    answers, the JAX report dict and its text."""
    report = postmortem.postmortem(FIXTURE)
    assert report["n_ranks"] == 2
    assert report["ranks"][1]["clock_offset_s"] == pytest.approx(2.0, abs=0.25)
    assert report["frontier_desync"] is True
    assert report["ranks"][0]["frontier"]["step"] == 5
    assert report["ranks"][1]["frontier"]["step"] == 4
    assert report["hang_ranks"] == [0]
    assert report["stalled_rank"] == 1
    assert report["step_skew"] == 0
    assert "rank 1 stalled first" in report["verdict"]
    assert "all-reduce@step 4" in report["verdict"]
    jpm = _jax_postmortem()
    assert report == jpm.postmortem(FIXTURE)
    assert postmortem.render_text(report) == jpm.render_text(report)
    assert timeline.clock_offsets_from_heartbeats(FIXTURE) == \
        jtimeline.clock_offsets_from_heartbeats(FIXTURE)
    assert timeline.read_heartbeat_steps(FIXTURE) == jtimeline.read_heartbeat_steps(FIXTURE)
    assert postmortem.main([FIXTURE, "--json"]) == 1


def test_postmortem_reads_the_same_dumps_as_jax(tmp_path):
    """A fixture written by the port's ``make_fixture`` is the JAX one, and
    an empty directory degrades the same way (exit 2)."""
    jpm = _jax_postmortem()
    postmortem.make_fixture(str(tmp_path / "port"))
    jpm.make_fixture(str(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    empty = postmortem.postmortem(str(tmp_path / "none"))
    assert empty == jpm.postmortem(str(tmp_path / "none"))
    assert postmortem.main([str(tmp_path / "none")]) == 2


@pytest.mark.parametrize("tool,needle", [("postmortem", "postmortem selftest: OK"),
                                         ("obs_live", "obs_live selftest: OK")])
def test_tool_selftests_pass_in_a_process_of_their_own(tool, needle):
    proc = subprocess.run(
        [sys.executable, "-m", f"pytorch_distributed_tpu_torch.tools.{tool}", "--selftest"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert needle in proc.stdout


# ------------------------------------------------------------------ alerts --

NOW = 1_790_000_000.0


def step_rec(step, st=0.010, proc=0, t=None, **extra):
    """The JAX tests' record (``tests/test_alerts.py::step_rec``)."""
    rec = {"step": step, "t": NOW if t is None else t, "process": proc, "step_time": st,
           "step_time_ema": st, "step_time_p50": st, "step_time_p95": st, "step_time_max": st}
    rec.update(extra)
    return rec


def _history(engine):
    return [{k: v for k, v in dataclasses.asdict(a).items() if k != "t"}
            for a in engine.history]


def _stream(name, tmp_path):
    """(rules, records, heartbeats) of the JAX tests' cases, seeded."""
    R = lambda mod: mod.Rule  # noqa: E731
    if name == "step_time":
        return (lambda mod: [R(mod)("step_time_p95", "st", "page",
                                    {"max_ms": 15.0, "warmup_steps": 2}),
                             R(mod)("step_time_p95", "st50", "warn",
                                    {"max_ms": 15.0, "quantile": "p50", "warmup_steps": 0})],
                [step_rec(0, st=0.050), step_rec(2), step_rec(3, st=0.020),
                 step_rec(4, st=0.030), step_rec(5), step_rec(6, st=0.020),
                 step_rec(3, st=0.020, proc=1), step_rec(4, st=0.020, proc=1)], None)
    if name == "comm_mem_goodput":
        recs = [step_rec(1, exposed_comm_ms=1.0, mem_peak_bytes=1000),
                step_rec(2, exposed_comm_ms=3.5, mem_peak_bytes=2 << 20), step_rec(3)]
        recs += [step_rec(i, st=0.2, t=1000.0 + i) for i in range(8)]
        return (lambda mod: [R(mod)("exposed_comm", "comm", "warn", {"max_ms": 2.0}),
                             R(mod)("mem_peak", "mem", "page", {"max_bytes": 1 << 20}),
                             R(mod)("goodput_floor", "gp", "warn",
                                    {"min_pct": 50.0, "min_steps": 5})], recs, None)
    if name == "serving_attr":
        rng = np.random.default_rng(7)
        recs = [step_rec(i, ttft_p99_ms=float(rng.uniform(50, 150)),
                         kv_occupancy_pct=float(rng.uniform(60, 99)),
                         queue_wait_share_p99=float(rng.uniform(10, 90)),
                         preempt_redo_ms_p99=float(rng.uniform(0, 200)),
                         data_wait_share=float(rng.uniform(0, 60))) for i in range(12)]
        return (lambda mod: [R(mod)("ttft_p99", "ttft", "page", {"max_ms": 100.0}),
                             R(mod)("kv_occupancy", "kv", "warn", {"max_pct": 90.0}),
                             R(mod)("queue_wait_share", "qw", "warn", {"max_pct": 50.0}),
                             R(mod)("preempt_redo", "redo", "warn", {"max_ms": 100.0}),
                             R(mod)("data_wait_share", "dw", "warn", {"max_pct": 25.0})],
                recs, None)
    if name == "events":
        return (lambda mod: [R(mod)("hang", "hang", "page", {}),
                             R(mod)("recompile", "rc", "warn", {"max_events": 1}),
                             R(mod)("replica_down", "rd", "page", {})],
                [{"ft_event": "hang", "step": 7, "process": 0, "t": 1.0,
                  "collective": "all-reduce", "elapsed_s": 12.0},
                 {"ft_event": "recompile", "step": 8, "t": 2.0, "process": 0},
                 {"ft_event": "alert", "alert": "hang", "rule": "hang", "t": 2.5},
                 {"ft_event": "recompile", "step": 9, "t": 3.0, "process": 0},
                 {"ft_event": "replica_down", "replica": 1, "reason": "probe", "t": 4.0}],
                None)
    if name == "heartbeats":
        beats = {0: {"pid": 0, "step": 20, "t": NOW, "ema": 0.010},
                 1: {"pid": 1, "step": 20, "t": NOW - 120.0, "ema": 0.010},
                 2: {"pid": 2, "step": 10, "t": NOW, "ema": 0.050},
                 3: {"pid": 3, "step": 20, "t": NOW, "ema": 0.010}}
        return (lambda mod: [R(mod)("dead_rank", "dead", "page", {"max_age_s": 60.0}),
                             R(mod)("slow_rank", "slow", "warn",
                                    {"max_step_lag": 3, "slow_ema_factor": 2.0,
                                     "max_age_s": 60.0})], [], beats)
    # bench_stale: temporary LKGs 20 and 2 days before NOW, an events log
    # with one stale event and a later capture: both engines age the files
    # each rule names, at NOW (no records: the lazy first-record check
    # would read the wall clock).
    def lkg(name, days):
        stamp = datetime.fromtimestamp(NOW - days * 86400, timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S%z")
        (tmp_path / name).write_text(json.dumps({"metric": "tok/s", "value": 1.0,
                                                 "captured_at": stamp, "predicted_mfu": 0.4,
                                                 "measured_mfu": 0.38}))
        return str(tmp_path / name)

    events = tmp_path / "bench_events.jsonl"
    events.write_text(json.dumps({"bench_event": "stale", "t": NOW - 86400}) + "\n"
                      + json.dumps({"bench_event": "captured", "t": NOW - 16 * 86400,
                                    "metric": "img/s"}) + "\n")
    stale = {"max_days": 14.0, "lkg_path": lkg("old.json", 20), "events_path": str(events)}
    fresh = {"max_days": 14.0, "lkg_path": lkg("new.json", 2)}
    return (lambda mod: [R(mod)("bench_stale", "stale", "warn", dict(stale)),
                         R(mod)("bench_stale", "fresh", "warn", dict(fresh))], [], None)


@pytest.mark.parametrize("name", ["step_time", "comm_mem_goodput", "serving_attr", "events",
                                  "heartbeats", "bench_stale"])
def test_alert_engines_book_the_same_history(tmp_path, name):
    rules, recs, beats = _stream(name, tmp_path)
    got = alerts.evaluate_stream(recs, rules(alerts), beats=beats, now=NOW)
    want = jalerts.evaluate_stream(recs, rules(jalerts), beats=beats, now=NOW)
    assert got.history, name
    assert _history(got) == _history(want)
    assert [(a.name, a.rank) for a in got.active()] == [(a.name, a.rank) for a in want.active()]
    events = [dict(a.fields(), ft_event="alert", t=NOW) for a in got.history]
    assert alerts.alerts_data(events) == jalerts.alerts_data(events)
    assert alerts.summarize_alerts(events) == jalerts.summarize_alerts(events)
    assert alerts.dead_ranks_from_events(events) == jalerts.dead_ranks_from_events(events)


def test_default_rules_age_no_lkg_whatever_the_date():
    """The two JAX cases that fail on a stale ``BENCH_LKG.json`` (C3): the
    port's default set has the same rules, but with no LKG named there is
    nothing to age, so neither books a ``bench_stale`` alert."""
    assert [(r.kind, r.name, r.severity, r.params) for r in alerts.default_rules()] == \
        [(r.kind, r.name, r.severity, r.params) for r in jalerts.default_rules()]
    eng = alerts.AlertEngine(alerts.default_rules())
    assert eng.observe({"ft_event": "alert", "alert": "hang", "rule": "hang", "t": 1.0,
                        "process": 0}) == []
    assert not eng.active()
    now = time.time()
    recs = [step_rec(i, t=now) for i in range(5)] + [
        {"ft_event": "hang", "step": 5, "t": now, "process": 0}]
    beats = {0: {"pid": 0, "step": 5, "t": now - 300.0}}
    eng = alerts.evaluate_stream(recs, alerts.default_rules(), beats=beats, now=now)
    assert {a.kind for a in eng.history} == {"hang", "dead_rank"}
    assert alerts.bench_staleness() is None
    for far in (now, now + 10 * 365 * 86400):
        assert alerts.AlertEngine(alerts.default_rules()).check_bench(now=far) == []


def test_rule_files_load_alike(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rules": [
        {"kind": "step_time_p95", "name": "st", "severity": "page", "max_ms": 25.0,
         "quantile": "p50", "warmup_steps": 3},
        {"kind": "dead_rank", "max_age_s": 30.0},
        {"kind": "bench_stale", "max_days": 7.0, "lkg_path": "/x.json"}]}))
    assert [dataclasses.asdict(r) for r in alerts.load_rules(str(p))] == \
        [dataclasses.asdict(r) for r in jalerts.load_rules(str(p))]
    for bad in ([{"kind": "nope"}], [{"kind": "hang", "max_ms": 1}],
                [{"kind": "hang"}, {"kind": "hang"}]):
        p.write_text(json.dumps(bad))
        with pytest.raises(alerts.AlertRuleError) as got:
            alerts.load_rules(str(p))
        with pytest.raises(jalerts.AlertRuleError) as want:
            jalerts.load_rules(str(p))
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ export --

DROPPED = {"ptd_uptime_seconds", "ptd_record_age_seconds", "ptd_mem_rss_bytes"}


def test_exporters_render_the_same_samples():
    rng = np.random.default_rng(3)
    rec = step_rec(41, st=0.020, proc=7, throughput=51200.0, loss=float(rng.normal()),
                   grad_norm=float(rng.uniform()), attr_compute_ms=9.0,
                   attr_data_wait_ms=7.7, data_wait_share=38.5, ttft_p99_ms=88.5,
                   queue_depth=3.0, flag=True, note="text")
    samples = {}
    for name, mod, amod in (("port", export, alerts), ("jax", jexport, jalerts)):
        eng = amod.AlertEngine([amod.Rule("step_time_p95", "st", "page",
                                          {"max_ms": 15.0, "warmup_steps": 0})])
        eng.observe(rec)
        exp = mod.MetricsExporter(0, rank=7, engine=eng)
        exp.update(rec)
        exp.update({"ft_event": "rollback", "t": NOW, "process": 7})
        exp.update({"ft_event": "alert", "t": NOW, "process": 7, "alert": "st"})
        got = mod.parse_prometheus(exp.render())
        samples[name] = sorted((n, sorted(lab.items()), v) for n, lab, v in got
                               if n not in DROPPED)
        # The exposition prints 6 significant digits (``%g``).
        assert mod.sample_value(got, "ptd_metric", rank=7, field="loss") == \
            float(f"{rec['loss']:g}")
    assert samples["port"] == samples["jax"]
    text = 'ptd_metric{rank="0",field="a,b"} 1.5\n# c\nptd_up{rank="0"} 1\ngarbage\n'
    assert export.parse_prometheus(text) == jexport.parse_prometheus(text)


def test_exporter_serves_healthz_503_then_200_on_an_ephemeral_port():
    exp = export.MetricsExporter(0, rank=0)
    exp.start()
    try:
        base = f"http://127.0.0.1:{exp.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/healthz", timeout=2.0)
        assert e.value.code == 503
        exp.update(step_rec(3))
        with urllib.request.urlopen(f"{base}/healthz", timeout=2.0) as r:
            assert r.status == 200 and json.loads(r.read())["ok"] is True
        samples = export.scrape(f"{base}/metrics")
        assert export.sample_value(samples, "ptd_up", rank=0) == 1.0
        assert export.sample_value(samples, "ptd_step", rank=0) == 3.0
        # A second exporter on the bound port cannot start: it raises.
        with pytest.raises(OSError):
            export.MetricsExporter(exp.port, rank=1).start()
    finally:
        exp.stop()
    assert not exp.running


# ---------------------------------------------------- preempt, chaos, misc --

@pytest.mark.parametrize("spec", ["term", "term,int", "SIGTERM, SIGINT", "15", "int,term,int",
                                  "usr1", "kill", "nope", ""])
def test_parse_signals_like_jax(spec):
    def call(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return f"ValueError: {e}"
    assert call(preempt.parse_signals) == call(jpreempt.parse_signals)


def test_agreement_without_a_group_answers_locally():
    agree = preempt.PreemptionAgreement(None, "cpu")
    assert agree(True) is True and agree(False) is False


def test_nan_batch_poisons_float_tensors_only():
    """As the JAX injector: at the listed steps the float entries become
    NaN, integer ones (labels, the LM's tokens) and unlisted keys pass."""
    inj = chaos.NaNBatchAt([2], keys=("images", "labels"))
    batch = {"images": torch.ones(2, 3), "labels": torch.arange(2), "w": torch.ones(2)}
    assert inj.on_batch(1, batch) is batch
    out = inj.on_batch(2, batch)
    assert torch.isnan(out["images"]).all() and torch.equal(out["labels"], batch["labels"])
    assert torch.equal(out["w"], batch["w"]) and inj.injected == [2]
    tokens = torch.arange(8).reshape(2, 4)
    assert chaos.NaNBatchAt([0]).on_batch(0, tokens) is tokens


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_file_is_the_jax_corruption(tmp_path, mode):
    blob = np.random.default_rng(9).bytes(4096)
    for name in ("port", "jax"):
        (tmp_path / name).write_bytes(blob)
    got = chaos.corrupt_file(str(tmp_path / "port"), mode, seed=4, nbytes=3)
    want = jchaos.corrupt_file(str(tmp_path / "jax"), mode, seed=4, nbytes=3)
    assert got == want
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes() != blob


def test_injectors_fire_at_the_jax_steps():
    """SignalAt, LRSpikeAt, DelayRank, SlowLoader and HangAt against their
    JAX twins over ten steps (sleeps of 0 s; SIGUSR1 to a recorder)."""
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))

    class T:
        lr = 0.1

    try:
        trace = {}
        for name, mod in (("port", chaos), ("jax", jchaos)):
            t = T()
            sched = mod.ChaosSchedule(mod.SignalAt(3, signal.SIGUSR1), mod.LRSpikeAt(5, 9.0),
                                      mod.DelayRank(0.0, every=4), mod.SlowLoader(0.0, every=3),
                                      mod.HangAt(6, 0.0))
            lrs = []
            for step in range(10):
                sched.on_step(t, step)
                sched.on_batch(step, None)
                sched.on_collective(t, step)
                lrs.append(t.lr)
            trace[name] = (lrs, len(hits), sched.injectors[3].injected,
                           sched.injectors[4].fired)
            hits.clear()
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert trace["port"] == trace["jax"]
    assert trace["port"][0][5] == 9.0 and trace["port"][1] == 1
