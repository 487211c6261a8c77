"""The port's serving fleet (``serving/{router,replica}.py``, ``ft/elastic.py``,
``tools/{serve_fleet,chaoskit}.py``) against the JAX package's, on the CPU.

- Decisions: ``sim_tokens``, the exactly-once ``CompletionLedger``,
  ``decide_scale``, ``fleet_reconciliation``, the rescale rules, liveness
  split, ``ElasticSim`` and the file-based ``ElasticCoordinator`` on the
  same beat files, and the ZeRO/residual re-grids must equal the JAX
  modules' exactly.
- An in-process fleet of two sim replicas and the router on loopback:
  dispatch, a retry to the other replica, a hedge that wins, drain, and
  exactly-once replay, each with the router's latency identity exact.
- ``serve_fleet --selftest``, ``chaoskit drill replica-kill`` and ``drill
  router-restart`` in subprocesses without torch, and ``serve_fleet
  bench``; ``EngineBackend`` on the CPU gives the tokens of a bare port
  engine, and behind the router its echoed TTFT equals its own trace's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ft import elastic as jel
from pytorch_distributed_tpu.obs import reqtrace as jrt
from pytorch_distributed_tpu.serving import replica as jrep
from pytorch_distributed_tpu.serving import router as jrouter
from pytorch_distributed_tpu_torch.ft import elastic as pel
from pytorch_distributed_tpu_torch.obs import metrics
from pytorch_distributed_tpu_torch.obs import reqtrace as prt
from pytorch_distributed_tpu_torch.serving import replica as prep
from pytorch_distributed_tpu_torch.serving import router as prouter
from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
from pytorch_distributed_tpu_torch.serving.scheduler import Request
from pytorch_distributed_tpu_torch.tools import serve_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ decisions


def test_sim_tokens_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        prompt = rng.randint(0, 500, size=rng.randint(0, 12)).tolist()
        n, vocab, seed = int(rng.randint(0, 16)), int(rng.randint(1, 300)), int(rng.randint(9))
        assert prep.sim_tokens(prompt, n, vocab, seed) == jrep.sim_tokens(prompt, n, vocab, seed)


def test_completion_ledger_matches_jax():
    rng = np.random.RandomState(1)
    ops = [(("book" if rng.rand() < 0.6 else "get"), int(rng.randint(12)), int(rng.randint(99)))
           for _ in range(200)]
    runs = []
    for mod in (jrouter, prouter):
        led = mod.CompletionLedger(max_entries=5)
        got = [led.book(rid, {"tokens": [v]}) if op == "book" else led.get(rid)
               for op, rid, v in ops]
        runs.append((got, led.duplicates, len(led)))
    assert runs[1] == runs[0] and runs[0][1] > 0


def _rows(rng, n):
    """Registry rows of a hot fleet (any state, queues, TTFT up to 800 ms)
    or, half the time, a cold one (UP, empty queues, TTFT under 200 ms)."""
    cold = rng.rand() < 0.5
    return [{"rid": i,
             "state": prouter.UP if cold else str(rng.choice(prouter.REPLICA_STATES)),
             "queue_depth": (0.0 if cold else float(rng.randint(0, 12)))
             if rng.rand() < 0.9 else None,
             "kv_occupancy_pct": float(rng.uniform(0, 100)),
             "ttft_p99_ms": float(rng.uniform(0, 200 if cold else 800))
             if rng.rand() < 0.9 else None,
             "inflight": int(rng.randint(0, 3))} for i in range(n)]


def test_decide_scale_matches_jax():
    rng = np.random.RandomState(2)
    seen = set()
    for _ in range(300):
        rows = _rows(rng, int(rng.randint(0, 6)))
        kw = dict(slo_ttft_ms=500.0, scale_up_pct=float(rng.choice([60.0, 85.0])),
                  min_replicas=int(rng.randint(1, 3)), max_replicas=int(rng.randint(2, 6)))
        got = prouter.decide_scale(rows, **kw)
        assert got == jrouter.decide_scale(rows, **kw)
        seen.add(got[0])
    assert seen == {"up", "down", None}


def test_fleet_reconciliation_matches_jax():
    rng = np.random.RandomState(3)
    fleet, engine = [], []
    for rid in range(10):
        parts = [round(float(rng.uniform(0, 50)), 4) for _ in range(4)]
        fleet.append({"ft_event": "fleettrace", "rid": rid, "attempts": int(rng.randint(1, 3)),
                      "hedged": int(rng.rand() < 0.3), "router_wait_ms": parts[0],
                      "redispatch_ms": parts[1], "hedge_wait_ms": parts[2],
                      "engine_ttft_ms": parts[3],
                      "router_ttft_ms": sum(parts) + float(rng.choice([0.0, 1e-3]))})
        if rid % 3:
            engine.append({"ft_event": "reqtrace", "rid": rid,
                           "ttft_ms": parts[3] + float(rng.choice([0.0, 0.5]))})
    got = prt.fleet_reconciliation(fleet, engine)
    assert got == jrt.fleet_reconciliation(fleet, engine)
    assert got["decomp_err_ms_max"] > 0 and got["engine_matched"] == 6
    assert prt.fleet_reconciliation([], engine) is None


def test_rescale_liveness_and_sim_match_jax():
    for rule in pel.RESCALE_RULES:
        for old, new in ((4, 2), (4, 8), (3, 3), (6, 4)):
            assert pel.rescale_lr(0.1, old, new, rule) == jel.rescale_lr(0.1, old, new, rule)
            assert (pel.rescale_batch(24, old, new, rule)
                    == jel.rescale_batch(24, old, new, rule))
    flagged = {1: "dead or hung: 120s", 2: "slow rank: ema 3x", 3: "slow rank + dead or hung"}
    assert pel.split_liveness(flagged) == jel.split_liveness(flagged)
    hist = []
    for mod in (jel, pel):
        sim = mod.ElasticSim(4, min_ranks=2)
        out = [sim.poll(0)]
        sim.force_lose(3, "chaos")
        out.append(sim.poll(1))
        sim.force_lose(2)
        sim.force_lose(1)   # below the floor: refused
        out.append(sim.poll(2))
        sim.force_join(3)
        out.append(sim.poll(3))
        hist.append(([None if c is None else (c.kind, c.old.to_json(), c.new.to_json(), c.reason)
                      for c in out], sim.refused))
    assert hist[1] == hist[0]


def _write_beats(d, ages, now, epoch, ema=None):
    os.makedirs(d, exist_ok=True)
    for r, age in ages.items():
        rec = {"pid": r, "step": 10, "t": now - age, "epoch": epoch}
        if ema is not None:
            rec["ema"] = ema.get(r, 0.1)
        with open(os.path.join(d, f"heartbeat-{r:05d}.jsonl"), "w") as f:
            f.write(json.dumps(rec) + "\n")


def test_coordinator_decisions_on_the_same_beat_files_match_jax(tmp_path):
    now = time.time()
    dirs = {mod: str(tmp_path / name) for mod, name in ((jel, "jax"), (pel, "port"))}
    cos = {mod: mod.ElasticCoordinator(d, world=4, min_ranks=2, max_age_s=60.0)
           for mod, d in dirs.items()}
    steps = [
        (dict(ages={0: 0, 1: 0, 2: 0, 3: 0}), None, ()),              # all fresh
        (dict(ages={0: 0, 1: 0, 2: 0, 3: 300}), None, ()),            # one stale: evict
        (dict(ages={0: 0, 1: 0, 2: 0}, ema={2: 5.0}), None, ()),      # slow stays
        (dict(ages={0: 0, 1: 0, 2: 0}), None, (3,)),                  # join request
        (dict(ages={0: 0, 1: 0, 2: 0, 3: 0}), {1: "alert: dead_rank"}, ()),  # extra_dead
        (dict(ages={0: 300, 1: 300, 2: 300, 3: 300}), None, ()),      # below the floor
    ]
    for beats, extra_dead, joins in steps:
        got = []
        for mod, co in cos.items():
            epoch = co.membership().epoch
            for name in os.listdir(dirs[mod]):
                if name.startswith("heartbeat-"):
                    os.remove(os.path.join(dirs[mod], name))
            _write_beats(dirs[mod], beats["ages"], now, epoch, beats.get("ema"))
            for r in joins:
                co.request_join(r)
            chg = co.decide(now=now, extra_dead=extra_dead)
            got.append((None if chg is None else
                        (chg.kind, chg.old.to_json(), chg.new.to_json(), chg.reason),
                        co.membership().to_json(), sorted(co.pending_joins())))
        assert got[1] == got[0]
    assert cos[pel].membership() == pel.Membership(3, (0, 2, 3))


def _wus(params, n, rng, quantized):
    from pytorch_distributed_tpu_torch.parallel import zero

    def stack(p):
        size = int(np.prod(p.shape))
        chunk = zero.chunk_size(size, n)
        flat = np.zeros(n * chunk, np.float32)
        flat[:size] = rng.normal(size=(size,)).astype(np.float32)
        return flat.reshape(n, chunk)

    out = {"buf": {k: stack(v) for k, v in params.items()}}
    if quantized:
        out["agerr"] = {k: stack(v) for k, v in params.items()}
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_regrids_match_jax_on_numpy_and_tensor_trees(quantized):
    rng = np.random.default_rng(0)
    params = {"kernel": rng.normal(size=(7, 300)).astype(np.float32),
              "bias": rng.normal(size=(13,)).astype(np.float32)}
    m4 = _wus(params, 4, rng, quantized)
    want = jel.regrid_wus_momentum(m4, params, 2)
    tensors = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in m4.items()}
    for mom, par in ((m4, params), (tensors, {k: torch.from_numpy(v) for k, v in params.items()})):
        got = pel.regrid_wus_momentum(mom, par, 2)
        assert set(got) == set(want)
        for k in want:
            for n in want[k]:
                np.testing.assert_array_equal(got[k][n], np.asarray(want[k][n]))
        back = pel.regrid_wus_momentum(got, params, 4)
        for k in m4:
            for n in m4[k]:
                np.testing.assert_array_equal(back[k][n], m4[k][n])
    with pytest.raises(ValueError, match="WUS layout"):
        pel.regrid_wus_momentum({"nope": 1}, params, 2)
    res = {"conv": [rng.normal(size=(4, 3, 5)).astype(np.float32)]}
    want = jel.regrid_stacked_residual(res, 2)
    for tree in (res, {"conv": [torch.from_numpy(res["conv"][0])]}):
        np.testing.assert_array_equal(pel.regrid_stacked_residual(tree, 2)["conv"][0],
                                      np.asarray(want["conv"][0]))


def test_membership_injectors_latch_on_the_ports_chaos_base():
    from pytorch_distributed_tpu_torch.ft.chaos import ChaosInjector

    class Trainer:
        def __init__(self):
            self.elastic = pel.ElasticSim(4)

    tr = Trainer()
    lose, join = pel.LoseRankAt(3, rank=2, reason="drill"), pel.JoinRankAt(5, rank=2)
    assert isinstance(lose, ChaosInjector)
    kinds = []
    for s in range(8):
        lose.on_step(tr, s)
        join.on_step(tr, s)
        chg = tr.elastic.poll(s)
        kinds.append(chg and (chg.kind, chg.new.ranks))
    assert kinds == [None] * 3 + [("shrink", (0, 1, 3)), None, ("grow", (0, 1, 2, 3)), None, None]
    pel.LoseRankAt(0, rank=0).on_step(object(), 0)   # no controller: ignored


# ------------------------------------------------------------ the fleet in-process


@pytest.fixture()
def fleet(tmp_path):
    made = []

    def boot(rid, itl_ms=0.5, max_batch=2):
        srv = prep.ReplicaServer(
            prep.SimEngineBackend(replica_id=rid, max_batch=max_batch,
                                  prefill_ms_per_token=0.05, itl_ms=itl_ms),
            replica_id=rid, hb_dir=str(tmp_path / "hb"), hb_interval_s=0.2)
        srv.start()
        made.append(srv)
        return srv

    yield boot
    for srv in made:
        srv.stop()


def _identity_exact(path, n):
    ftrs = prt.fleet_trace_records(metrics.read_metrics(path))
    assert len(ftrs) == n
    for t in ftrs:
        assert t["router_ttft_ms"] == (t["router_wait_ms"] + t["redispatch_ms"]
                                       + t["hedge_wait_ms"] + t["engine_ttft_ms"])
    return ftrs


def test_fleet_dispatch_retry_hedge_drain_exactly_once(fleet, tmp_path):
    p = [3, 1, 4, 1, 5]
    r0, r1 = fleet(0), fleet(1)
    jsonl = str(tmp_path / "router.jsonl")
    obs = metrics.MetricsLogger(jsonl, process_index=-2, flush_every=1)
    reg = prouter.ReplicaRegistry({0: r0.url, 1: r1.url}, hb_dir=str(tmp_path / "hb"),
                                  backoff_initial_s=0.05, probe_timeout=1.0)
    rt = prouter.FleetRouter(reg, prouter.RouterPolicy(deadline_s=10.0, max_retries=2,
                                                       retry_backoff_s=0.01), obs=obs)
    reg.probe()
    assert [r.state for r in reg.replicas.values()] == [prouter.UP, prouter.UP]
    # dispatch: the sim's exact tokens, least-loaded over both replicas
    for rid in range(4):
        code, res = rt.submit({"rid": rid, "prompt": p, "max_new_tokens": 6})
        assert code == 200 and res["tokens"] == prep.sim_tokens(p, 6, 64, 0)
        assert res["attempts"] == 1 and not res["hedged"]
    # exactly once: a replayed rid returns the first completion
    code, again = rt.submit({"rid": 2, "prompt": p, "max_new_tokens": 6})
    assert again["replayed"] and rt.stats.as_dict()["duplicates_suppressed"] == 1
    # retry: replica 1 dies unprobed and looks the least loaded
    r1.stop()
    reg.replicas[0].queue_depth = 5.0
    code, res = rt.submit({"rid": 10, "prompt": p, "max_new_tokens": 4})
    assert code == 200 and res["replica"] == 0 and res["attempts"] == 2
    assert {"dispatch:replica1", "retry:replica0"} <= set(res["ctx"]["hops"])
    assert reg.replicas[1].state == prouter.QUARANTINED
    assert rt.stats.as_dict()["replica_down_events"] == 1
    # hedge: a slow replica 2 goes first; the hedge to replica 0 wins
    r2 = fleet(2, itl_ms=60.0)
    reg.add(2, r2.url)
    reg.probe()
    reg.replicas[0].queue_depth = 5.0
    rt.policy.hedge, rt.policy.hedge_min_s, rt.policy.hedge_floor_samples = True, 0.02, 2
    rt._latency_ms.extend([5.0] * 4)
    code, res = rt.submit({"rid": 11, "prompt": p, "max_new_tokens": 8})
    d = rt.stats.as_dict()
    assert code == 200 and res["replica"] == 0 and res["hedged"]
    assert (d["hedges"], d["hedges_won"]) == (1, 1)
    assert {"dispatch:replica2", "hedge:replica0"} <= set(res["ctx"]["hops"])
    t_end = time.monotonic() + 5.0
    while r2.backend.cancelled < 1 and time.monotonic() < t_end:
        time.sleep(0.01)
    assert r2.backend.cancelled == 1, "the losing primary should be cancelled"
    # drain: the router refuses new work, a draining replica probes DRAINING
    assert r0.handle_drain(wait=True, timeout_s=2.0)["drained"]
    reg.probe()
    assert reg.replicas[0].state == prouter.DRAINING
    rt.drain()
    assert rt.submit({"rid": 12, "prompt": p, "max_new_tokens": 2})[0] == 503
    obs.close()
    assert len(rt.ledger) == 6
    ftrs = _identity_exact(jsonl, 6)
    assert {t["rid"]: (t["attempts"], t["hedged"]) for t in ftrs}[10] == (2, 0)
    assert sum(t["redispatch_ms"] > 0 for t in ftrs) == 1
    assert any(t["hedge_wait_ms"] > 0 for t in ftrs)


# ------------------------------------------------------------ subprocesses


def _torch_free(call):
    code = ("import sys\n" + call +
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_serve_fleet_selftest_runs_without_torch():
    out = _torch_free("from pytorch_distributed_tpu_torch.tools import serve_fleet\n"
                      "rc = serve_fleet.main(['--selftest'])\n")
    assert "serve_fleet selftest: OK" in out


@pytest.mark.parametrize("kind", ["replica-kill", "router-restart"])
def test_fleet_drills_run_without_torch(kind, tmp_path):
    out = _torch_free("from pytorch_distributed_tpu_torch.tools import chaoskit\n"
                      f"rc = chaoskit.main(['drill', {kind!r}, '--steps', '12', '--seed', '3', "
                      f"'--out', {str(tmp_path)!r}])\n")
    assert f"drill {kind}: OK" in out
    if kind == "replica-kill":
        assert "zero lost, zero double-completed" in out


def test_chaoskit_names_the_roadmap_item_for_what_waits():
    from pytorch_distributed_tpu_torch.tools import chaoskit

    for argv in (["--selftest"], ["drill", "shrink"], ["corrupt", "f"]):
        with pytest.raises(SystemExit, match="ROADMAP.md item A11"):
            chaoskit.main(argv)


def test_bench_writes_only_where_asked(tmp_path, capsys):
    out = tmp_path / "fleet.json"
    assert serve_fleet.main(["bench", "--fleet-sizes", "1,2", "--requests", "16",
                             "--sim-itl-ms", "1", "--min-scaling", "0", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["all_completed"] and [r["replicas"] for r in res["runs"]] == [1, 2]
    assert serve_fleet.main(["bench", "--out", os.path.join(REPO, "RESULTS_fleet.json")]) == 2
    capsys.readouterr()


def test_engine_backend_gives_the_tokens_of_a_bare_engine():
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
    eng_cfg = dict(max_batch=4, kv_blocks=32, block_size=8, blocks_per_seq=8, chunk_size=8)
    rng = np.random.RandomState(5)
    reqs = [(i, rng.randint(1, 64, size=int(rng.randint(3, 20))).tolist(), int(rng.randint(2, 12)))
            for i in range(6)]
    bare = ServingEngine(init_lm_params(**cfg, seed=3, device="cpu"), **cfg, **eng_cfg,
                         max_new_tokens=16, device="cpu")
    bare.run([(0.0, Request(rid=i, prompt=p, max_new_tokens=n)) for i, p, n in reqs])
    want = {r.rid: r.generated for r in bare.finished}
    backend = prep.EngineBackend(**cfg, **eng_cfg, max_new_tokens=16, seed=3, device="cpu")
    try:
        import threading

        got = {}

        def gen(i, p, n):
            got[i] = backend.generate(i, p, n)

        threads = [threading.Thread(target=gen, args=r) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        backend.close()
    assert all(got[i]["ok"] for i, _, _ in reqs)
    assert {i: got[i]["tokens"] for i, _, _ in reqs} == want


def test_engine_replica_echo_matches_its_own_trace_and_launches_no_kernel(tmp_path):
    """A traced ``EngineBackend`` behind the router: every ``fleettrace``
    record's ``engine_ttft_ms`` equals the replica's own ``reqtrace`` TTFT
    exactly, and ``/stats`` reports each kernel wrapper's launches (none)."""
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
    eng_cfg = dict(max_batch=2, kv_blocks=32, block_size=8, blocks_per_seq=8, chunk_size=8)
    rep_jsonl, rt_jsonl = str(tmp_path / "replica.jsonl"), str(tmp_path / "router.jsonl")
    rep_obs = metrics.MetricsLogger(rep_jsonl, process_index=0, flush_every=1)
    srv = prep.ReplicaServer(prep.EngineBackend(
        **cfg, **eng_cfg, max_new_tokens=8, seed=3, obs=rep_obs, device="cpu",
        trace=prt.ReqTracer(sample=1.0, hop="engine:0")), replica_id=0)
    srv.start()
    obs = metrics.MetricsLogger(rt_jsonl, process_index=-2, flush_every=1)
    try:
        reg = prouter.ReplicaRegistry({0: srv.url}, probe_timeout=5.0)
        rt = prouter.FleetRouter(reg, prouter.RouterPolicy(deadline_s=60.0), obs=obs)
        reg.probe()
        rng = np.random.RandomState(7)
        for rid in range(4):
            code, res = rt.submit({"rid": rid, "prompt": rng.randint(1, 64, size=9).tolist(),
                                   "max_new_tokens": 5})
            assert code == 200 and res["ok"] and len(res["tokens"]) == 5
        stats = srv.stats()
    finally:
        srv.stop()
        obs.close()
        rep_obs.close()
    assert stats["kernel_launches"] == {
        "flash_attention": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
        "fused_dgrad_wgrad": 0, "fused_dgrad_wgrad_3x3": 0}
    ftrs = _identity_exact(rt_jsonl, 4)
    rec = prt.fleet_reconciliation(ftrs, prt.trace_records(metrics.read_metrics(rep_jsonl)))
    assert rec["engine_matched"] == 4 and rec["engine_echo_err_ms_max"] == 0
    assert prep.ReplicaServer(prep.SimEngineBackend()).stats()["kernel_launches"] is None
