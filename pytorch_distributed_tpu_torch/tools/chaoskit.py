"""chaoskit — the serving drills of the JAX package's ``scripts/chaoskit.py``,
against the port's entry points.

    python -m pytorch_distributed_tpu_torch.tools.chaoskit drill replica-kill --seed 3
    python -m pytorch_distributed_tpu_torch.tools.chaoskit drill router-restart --seed 3
    python -m pytorch_distributed_tpu_torch.tools.chaoskit drill trace --device cpu

- ``drill replica-kill`` boots two torch-free sim replicas
  (``tools/serve_fleet.py replica``) behind an in-process fleet router and
  runs the same seeded load twice: once as it is, once with replica 1
  SIGKILLed while it holds requests (after the seed's ``drill_plan``
  completion count).  It passes iff every request completes exactly once,
  the tokens equal the unkilled run's, ttft_p99 holds inside a 3x + 250 ms
  ceiling, the router books the ``replica_down`` ft_event and its alert,
  and every ``fleettrace`` record's latency identity holds exactly
  (``tools/obs_trace.py``'s fleet reconciliation).  ``replica_kill`` is the
  same drill as a function; ``chip_smoke.py`` runs it over two
  ``replica --engine --device cuda`` processes at the LM's full width.
- ``drill router-restart`` SIGKILLs the router process itself mid-run and
  restarts it; clients replay, and it passes iff every request completes
  exactly once with the expected tokens (the replicas' rid caches, or a
  deterministic recompute, absorb the lost ledger).
- ``drill trace`` runs a seeded preemption storm through the port's
  engine on ``--device`` (``cuda`` unless ``cpu`` is asked for) with
  ``--req-trace``'s recorder and passes iff every request completes, the
  tail attribution (``tools/obs_trace.py --json``) names ``preempt_redo``,
  and the ``preempt_redo`` alert fires live on the exporter and is booked
  in the JSONL.

The two fleet drills import no torch.  Every other chaoskit command
(``corrupt``, ``verify``, ``seal``, ``--selftest`` and the drills
``shrink``, ``grow``, ``hang``, ``alert``, ``serve``, ``desync`` and
``slow-loader``) exits naming ROADMAP.md item A11, which will port it.
Every drill shares the ``--seed`` contract: the injection point comes from
``drill_plan(seed, steps)``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time

from pytorch_distributed_tpu_torch.obs import alerts, metrics, reqtrace
from pytorch_distributed_tpu_torch.serving import replica, router

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NOT_PORTED = "A11 (fault tolerance: the rest of scripts/chaoskit.py)"
SERVING_DRILLS = ("trace", "replica-kill", "router-restart")
DRILLS = ("shrink", "grow", "hang", "alert", "serve", "trace", "desync", "replica-kill",
          "router-restart", "slow-loader")


def drill_plan(seed: int, steps: int):
    """Seed-deterministic (lose_step, join_step) — same seed, same schedule,
    every time (the chaoskit contract; the JAX package's function)."""
    rng = random.Random(int(seed))
    if steps < 8:
        raise ValueError(f"drill needs >= 8 steps, got {steps}")
    lose = rng.randrange(2, steps // 2)
    join = rng.randrange(lose + 2, steps - 1)
    return lose, join


# ------------------------------------------------------------------ trace


class _PreemptStorm:
    """Chaos injector for ``drill trace``: from ``start`` on, evict the
    scheduler's preferred victim every ``every`` steps (duck-typed into
    the engine's ``chaos.on_step`` hook).  The guard keeps at least one
    lane live so the run always terminates."""

    def __init__(self, every: int = 1, start: int = 3):
        self.every, self.start = every, start

    def on_step(self, eng, step: int) -> None:
        if step < self.start or step % self.every:
            return
        if len(eng.sched.active) > 1:
            victim = eng.sched.pick_victim()
            if victim is not None:
                eng._preempt(victim)


def _drill_trace(args) -> int:
    """A seeded preemption storm — a tiny KV pool under priority
    scheduling plus a ``_PreemptStorm`` evicting a victim every step —
    thrashes every request through preempt/requeue/recompute.  Passes iff
    every request completes, the tail attribution names ``preempt_redo``
    with components that sum to each TTFT, and the ``preempt_redo`` alert
    fires live on the rank's exporter and is booked in the JSONL."""
    import socket
    import urllib.request

    import numpy as np

    from pytorch_distributed_tpu_torch.obs.export import MetricsExporter, parse_prometheus
    from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
    from pytorch_distributed_tpu_torch.serving.scheduler import Request

    out = args.out or tempfile.mkdtemp(prefix="trace-drill-")
    os.makedirs(out, exist_ok=True)
    mpath = os.path.join(out, "serving.jsonl")
    n_requests, slo_ms = 24, 40.0
    with socket.socket() as s:  # free localhost port for the exporter
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    print(f"drill trace: preemption storm over a 24-block pool, {n_requests} requests vs "
          f"{slo_ms:.0f}ms TTFT SLO on {args.device}, exporter on :{port}, artifacts in '{out}'")

    cfg = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2,
               max_batch=4, kv_blocks=24, block_size=4, blocks_per_seq=8,
               chunk_size=4, max_new_tokens=6, policy="priority",
               defrag_threshold_pct=200.0)  # never defrag: isolate redo
    params = init_lm_params(cfg["vocab_size"], cfg["d_model"], cfg["n_heads"],
                            cfg["n_layers"], seed=args.seed, device=args.device)
    # a warm-up engine first, so the measured run's first prefill does not
    # carry the device's first-use costs into its attribution
    warm = ServingEngine(params, seed=args.seed, device=args.device, **cfg)
    warm.run([(0.0, Request(rid=0, prompt=[1] * 8, max_new_tokens=2))])

    obs = metrics.MetricsLogger(mpath, flush_every=1)
    alert_engine = alerts.AlertEngine(
        [alerts.Rule("preempt_redo", "preempt_redo", "page", {"max_ms": 50.0}),
         alerts.Rule("queue_wait_share", "queue_wait_share", "warn", {"max_pct": 15.0})],
        emit=lambda **f: obs.log_event("alert", **f))
    exporter = MetricsExporter(port, rank=0, engine=alert_engine)
    exporter.start()
    obs.register(alert_engine.observe)
    obs.register(exporter.update)
    tracer = reqtrace.ReqTracer(slo_ms=slo_ms, sample=1.0)

    # scrape /metrics concurrently: the preempt_redo alert and the
    # ptd_serving_attr_* gauges must be visible while the run is live
    seen = {"firing": set(), "gauges": set(), "scrapes": 0}
    stop = threading.Event()

    def _scrape():
        url = f"http://127.0.0.1:{port}/metrics"
        while not stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=1.0) as r:
                    samples = parse_prometheus(r.read().decode("utf-8", "replace"))
                seen["scrapes"] += 1
                for name, lab, v in samples:
                    if name == "ptd_alert_firing" and v:
                        seen["firing"].add(lab.get("rule"))
                    if name.startswith("ptd_serving_attr_"):
                        seen["gauges"].add(name)
            except Exception:
                pass
            stop.wait(0.05)

    th = threading.Thread(target=_scrape, daemon=True)
    th.start()

    eng = ServingEngine(params, obs=obs, chaos=_PreemptStorm(every=1, start=3), trace=tracer,
                        seed=args.seed, device=args.device, **cfg)
    rng = np.random.RandomState(7)
    load = []
    for i in range(n_requests):
        prompt = [int(x) for x in rng.randint(1, cfg["vocab_size"], size=int(rng.randint(20, 29)))]
        load.append((i * 0.002, Request(rid=i, prompt=prompt,
                                        max_new_tokens=cfg["max_new_tokens"],
                                        priority=2 if i % 3 == 0 else 0)))
    try:
        summary = eng.run(load)
        # one last scrape after the run's final record: on a fast device
        # the whole run can fit between two scrapes
        time.sleep(0.1)
    finally:
        stop.set()
        th.join(timeout=2.0)
        exporter.stop()
        obs.close()

    ok = True
    if summary["completed"] != n_requests:
        print(f"FAIL: {summary['completed']}/{n_requests} requests completed under the storm")
        ok = False
    if summary.get("preemptions", 0) < n_requests:
        print(f"FAIL: storm too weak — {summary.get('preemptions')} preemption(s)")
        ok = False

    probe = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.tools.obs_trace",
         "--metrics-jsonl", mpath, "--json"], capture_output=True, text=True, cwd=_REPO)
    attr = json.loads(probe.stdout) if probe.returncode == 0 else {}
    dominant = (attr.get("tail") or {}).get("dominant")
    if dominant != "preempt_redo":
        print(f"FAIL: tail attribution names {dominant!r}, want 'preempt_redo' "
              f"(obs_trace rc {probe.returncode})")
        ok = False
    if attr and attr.get("recon_err_ms_max", 1e9) >= 0.05:
        print(f"FAIL: component sums drifted from TTFT by {attr['recon_err_ms_max']:.3f}ms")
        ok = False
    if attr.get("violations", 0) < 1:
        print("FAIL: storm produced no SLO violations to attribute")
        ok = False
    if "preempt_redo" not in seen["firing"]:
        print(f"FAIL: live scrape never saw ptd_alert_firing{{rule=\"preempt_redo\"}} "
              f"({seen['scrapes']} scrape(s), saw {sorted(seen['firing'])})")
        ok = False
    if "ptd_serving_attr_preempt_redo_ms" not in seen["gauges"]:
        print(f"FAIL: live scrape never saw the ptd_serving_attr_* gauges "
              f"(saw {sorted(seen['gauges'])})")
        ok = False
    booked = {str(e.get("alert")) for e in metrics.read_metrics(mpath)
              if e.get("ft_event") == "alert"}
    if "preempt_redo" not in booked:
        print(f"FAIL: no 'preempt_redo' alert ft_event in '{mpath}' (booked: {sorted(booked)})")
        ok = False
    if not ok:
        return 1
    shares = attr["tail"]["shares_pct"]
    print(json.dumps({"completed": summary["completed"],
                      "preemptions": summary.get("preemptions"),
                      "violations": attr.get("violations"),
                      "preempt_redo_ms_p99": attr.get("preempt_redo_ms_p99"),
                      "redo_share_pct": round(shares.get("preempt_redo", 0.0), 1)},
                     sort_keys=True))
    print(f"drill trace: preempt_redo owns {shares.get('preempt_redo', 0.0):.0f}% of the p99 "
          "TTFT, alert booked live")
    print("drill trace: OK")
    return 0


# ------------------------------------------------------------------ fleet


def boot_replicas(out: str, tag: str, rids, seed: int, flags=(), timeout_s: float = 20.0):
    """Start one ``tools/serve_fleet.py replica`` process per rid, all at
    once, beating into ``out/hb-<tag>``, logging to
    ``out/<tag>-replica<rid>.log`` and writing its records (its
    ``reqtrace`` events among them) to ``out/<tag>-replica<rid>.jsonl``;
    returns ``(procs, urls)`` once every port file has landed.  ``flags`` are extra ``replica`` flags (the sim
    backend's by default; ``--engine --device cuda`` and the LM width for
    the port's engine)."""
    procs, files, logs = {}, {}, {}
    for rid in rids:
        files[rid] = os.path.join(out, f"{tag}-replica{rid}.port")
        logs[rid] = os.path.join(out, f"{tag}-replica{rid}.log")
        jsonl = os.path.join(out, f"{tag}-replica{rid}.jsonl")
        for old in (files[rid], jsonl):
            if os.path.exists(old):
                os.remove(old)   # an earlier run's port and records
        with open(logs[rid], "w") as log:
            procs[rid] = subprocess.Popen(
                [sys.executable, "-m", "pytorch_distributed_tpu_torch.tools.serve_fleet",
                 "replica", "--replica-id", str(rid), "--port-file", files[rid],
                 "--seed", str(seed), "--hb-dir", os.path.join(out, f"hb-{tag}"),
                 "--metrics-jsonl", jsonl, *flags],
                cwd=_REPO, stdout=log, stderr=subprocess.STDOUT)
    t_end = time.monotonic() + timeout_s
    urls = {}
    while len(urls) < len(files):
        for rid, pf in files.items():
            if rid not in urls and os.path.exists(pf):
                with open(pf) as f:
                    urls[rid] = f"http://127.0.0.1:{int(f.read().strip())}"
            if procs[rid].poll() is not None and rid not in urls:
                stop_all(procs)
                with open(logs[rid]) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(f"replica {rid} exited with {procs[rid].returncode} "
                                   f"before writing its port file:\n{tail}")
        if time.monotonic() > t_end:
            stop_all(procs)
            raise RuntimeError(f"replicas {sorted(set(files) - set(urls))} never wrote "
                               f"their port files in {timeout_s} s")
        time.sleep(0.02)
    return procs, urls


def stop_all(procs) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10.0)


def _p99(vals):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(0.99 * len(vals)))] if vals else None


def replica_kill(out: str, *, seed: int, prompts, max_new, flags=(), boot_timeout_s=20.0,
                 deadline_s=30.0, probe_timeout_s=1.0, kill_after=None, same_tokens=None):
    """The replica-kill drill over two replicas started with ``flags``.

    One pair of replica processes serves both runs: the unkilled run as
    rids ``0..n-1``, then the killed run as rids ``n..2n-1`` with the same
    prompts (so the replicas' rid caches never answer it), each behind its
    own router, ledger and JSONL.  Replica 1 dies after completion number
    ``kill_after`` (the seed's ``drill_plan`` unless given), at the first
    moment its engine holds a request.  ``same_tokens(i, base, kill)``
    judges request i's tokens (default: equal).  Besides the JAX drill's
    checks, every ``fleettrace`` record's ``engine_ttft_ms`` must equal the
    TTFT of the serving replica's own ``reqtrace`` record for that rid.
    The report's ``replica_launches`` are each replica's kernel launch
    counts (``/stats``; None for the sim backend): replica 0's after the
    killed run, replica 1's from the reading that released the kill.
    Returns ``(ok, report)``."""
    n_req = len(prompts)
    if kill_after is None:
        kill_after, _ = drill_plan(seed, n_req)
    os.makedirs(out, exist_ok=True)
    procs, urls = boot_replicas(out, "fleet", (0, 1), seed, flags, boot_timeout_s)
    hb_dir = os.path.join(out, "hb-fleet")

    def run(tag: str, rid0: int, kill_victim: bool):
        jsonl = os.path.join(out, f"router-{tag}.jsonl")
        if os.path.exists(jsonl):
            os.remove(jsonl)   # an earlier drill's records
        obs = metrics.MetricsLogger(jsonl, process_index=-2, flush_every=1)
        engine = alerts.AlertEngine(
            [alerts.Rule(kind="replica_down", name="replica_down", severity="page", params={})],
            emit=lambda **f: obs.log_event("alert", **f), process_index=-2)
        registry = router.ReplicaRegistry(urls, hb_dir=hb_dir, backoff_initial_s=0.05,
                                          probe_timeout=probe_timeout_s)
        rt = router.FleetRouter(
            registry, router.RouterPolicy(deadline_s=deadline_s, max_retries=3,
                                          retry_backoff_s=0.01, seed=seed),
            obs=obs, alert_engine=engine)
        registry.probe()
        results = [None] * n_req
        done_at = [None] * n_req
        lock = threading.Lock()

        def fire(i: int):
            time.sleep(i * 0.004)
            code, res = rt.submit({"rid": rid0 + i, "prompt": prompts[i],
                                   "max_new_tokens": max_new[i]})
            with lock:
                results[i] = (code, res)
                done_at[i] = time.monotonic()

        killed = {"t": None}

        def busy(victim) -> int:
            """Requests inside replica 1's engine right now: its own count
            (the router's also holds answers still in transit, and an
            engine finishes a batch's requests in one step)."""
            try:
                st = router.http_json("GET", victim.base_url + "/stats", None, 1.0)
            except router.TRANSPORT_ERRORS:
                return 0
            launches[1] = st.get("kernel_launches")
            return int(st["inflight"])

        def killer():
            victim = registry.replicas[1]
            t_end = time.monotonic() + deadline_s
            while time.monotonic() < t_end:
                done = rt.stats.as_dict()["requests_completed"]
                if done >= n_req:
                    return  # run finished before the plan's kill point
                if done >= kill_after and victim.inflight > 0 and busy(victim) > 0:
                    break
                time.sleep(0.002)
            procs[1].send_signal(signal.SIGKILL)
            killed["t"] = time.monotonic()

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(n_req)]
        kt = threading.Thread(target=killer) if kill_victim else None
        t0 = time.monotonic()
        for t in threads:
            t.start()
        if kt is not None:
            kt.start()
        for t in threads:
            t.join(timeout=2 * deadline_s)
        if kt is not None:
            kt.join(timeout=deadline_s)
        wall = time.monotonic() - t0
        rt.log_cycle(wall)
        obs.close()
        good = [r for r in results if r and r[0] == 200 and r[1].get("ok")]
        reroute_ms = None
        if killed["t"] is not None:
            # completions that had been dispatched to replica 1 and were
            # served elsewhere after the kill
            moved = [done_at[i] for i, r in enumerate(results)
                     if r and r[0] == 200 and r[1].get("ok") and r[1]["replica"] != 1
                     and "dispatch:replica1" in r[1]["ctx"]["hops"]
                     and done_at[i] >= killed["t"]]
            if moved:
                reroute_ms = (min(moved) - killed["t"]) * 1e3
        return {"results": results, "stats": rt.stats.as_dict(), "ledger": len(rt.ledger),
                "ttft_p99_ms": _p99(r[1]["router_ttft_ms"] for r in good), "jsonl": jsonl,
                "killed_at": killed["t"], "reroute_ms": reroute_ms, "wall_s": wall,
                "dispatched": [registry.replicas[r].dispatched for r in (0, 1)]}

    launches = {}
    try:
        base = run("base", 0, kill_victim=False)
        kill = run("kill", n_req, kill_victim=True)
        try:
            launches[0] = router.http_json("GET", urls[0] + "/stats", None,
                                           5.0).get("kernel_launches")
        except router.TRANSPORT_ERRORS:
            launches[0] = None
    finally:
        stop_all(procs)

    ok = True
    for tag, r in (("base", base), ("kill", kill)):
        lost = [i for i, res in enumerate(r["results"])
                if not (res and res[0] == 200 and res[1].get("ok"))]
        if lost:
            print(f"FAIL: {tag} run lost request(s) {lost}")
            ok = False
        if r["ledger"] != n_req:
            print(f"FAIL: {tag} ledger holds {r['ledger']} completions, want {n_req}")
            ok = False
        if r["stats"]["duplicates_suppressed"] != 0:
            print(f"FAIL: {tag} run double-completed {r['stats']['duplicates_suppressed']} "
                  "request(s)")
            ok = False
    if kill["killed_at"] is None:
        print("FAIL: the killer never fired — the fault was not injected")
        ok = False
    if kill["stats"]["retries"] < 1:
        print("FAIL: no redispatch despite a killed replica")
        ok = False
    if kill["stats"]["replica_down_events"] < 1:
        print("FAIL: router never saw the UP -> QUARANTINED transition")
        ok = False
    if ok:
        for i in range(n_req):
            b, k = base["results"][i][1]["tokens"], kill["results"][i][1]["tokens"]
            if not (same_tokens(i, b, k) if same_tokens is not None else b == k):
                print(f"FAIL: request {i}'s tokens diverge after the redispatch")
                ok = False
                break
    if base["ttft_p99_ms"] and kill["ttft_p99_ms"]:
        ceiling = base["ttft_p99_ms"] * 3.0 + 250.0
        if kill["ttft_p99_ms"] > ceiling:
            print(f"FAIL: ttft_p99 {kill['ttft_p99_ms']:.1f} ms blew the ceiling "
                  f"{ceiling:.1f} ms (baseline {base['ttft_p99_ms']:.1f} ms)")
            ok = False
    recs = metrics.read_metrics(kill["jsonl"])
    if "replica_down" not in {r.get("ft_event") for r in recs}:
        print("FAIL: no replica_down ft_event in the router JSONL")
        ok = False
    if not [r for r in recs if r.get("ft_event") == "alert" and r.get("rule") == "replica_down"]:
        print("FAIL: no replica_down alert booked")
        ok = False
    engine_trs = [t for rid in (0, 1) for t in reqtrace.trace_records(
        metrics.read_metrics(os.path.join(out, f"fleet-replica{rid}.jsonl")))]
    decomp, echo = [], []
    for tag, r in (("base", base), ("kill", kill)):
        ftrs = reqtrace.fleet_trace_records(metrics.read_metrics(r["jsonl"]))
        bad = [t["rid"] for t in ftrs
               if t["router_ttft_ms"] != (t["router_wait_ms"] + t["redispatch_ms"]
                                          + t["hedge_wait_ms"] + t["engine_ttft_ms"])]
        if len(ftrs) != n_req or bad:
            print(f"FAIL: {tag} run's fleettrace records: {len(ftrs)} of {n_req}, identity "
                  f"broken for rids {bad}")
            ok = False
        rec = reqtrace.fleet_reconciliation(ftrs, engine_trs) if ftrs else None
        decomp.append(rec and rec["decomp_err_ms_max"])
        echo.append(rec and rec["engine_echo_err_ms_max"])
        # the router reports the engine's own TTFT: both are the same
        # double rounded to 4 decimals, so they agree exactly
        if rec is None or rec["engine_matched"] != len(ftrs) or rec["engine_echo_err_ms_max"] != 0:
            print(f"FAIL: {tag} run's echoed engine TTFTs: "
                  f"{rec and rec['engine_matched']} of {len(ftrs)} matched a replica's "
                  f"reqtrace record, largest difference {rec and rec['engine_echo_err_ms_max']} ms")
            ok = False
    report = {"requests": n_req, "kill_after": kill_after,
              "base_ttft_p99_ms": base["ttft_p99_ms"], "kill_ttft_p99_ms": kill["ttft_p99_ms"],
              "base_wall_s": base["wall_s"], "kill_wall_s": kill["wall_s"],
              "retries": kill["stats"]["retries"],
              "replica_down_events": kill["stats"]["replica_down_events"],
              "kill_to_reroute_ms": kill["reroute_ms"], "decomp_err_ms_max": decomp,
              "engine_echo_err_ms_max": echo, "replica_launches": launches,
              "dispatched": [base["dispatched"], kill["dispatched"]],
              "lost": sum(1 for r in kill["results"] if not (r and r[1].get("ok"))),
              "double_completed": kill["stats"]["duplicates_suppressed"],
              "base_tokens": [r and r[1].get("tokens") for r in base["results"]],
              "kill_tokens": [r and r[1].get("tokens") for r in kill["results"]]}
    return ok, report


def _drill_replica_kill(args) -> int:
    out = args.out or tempfile.mkdtemp(prefix="ptd-drill-fleet-")
    os.makedirs(out, exist_ok=True)
    n_req = max(args.steps, 8)
    rng = random.Random(args.seed)
    prompts = [[rng.randrange(64) for _ in range(8)] for _ in range(n_req)]
    print(f"drill replica-kill: {n_req} requests over 2 replicas, SIGKILL replica 1 after "
          f"completion #{drill_plan(args.seed, n_req)[0]} (seed {args.seed})")
    ok, rep = replica_kill(out, seed=args.seed, prompts=prompts, max_new=[8] * n_req,
                           flags=("--sim-itl-ms", "6.0", "--sim-prefill-ms", "0.5",
                                  "--max-batch", "2"))
    if not ok:
        return 1
    print(json.dumps({k: v for k, v in rep.items() if not k.endswith("_tokens")},
                     sort_keys=True))
    print("drill replica-kill: zero lost, zero double-completed, tokens bit-exact across the "
          "redispatch")
    print("drill replica-kill: OK")
    return 0


def _drill_router_restart(args) -> int:
    """SIGKILL the *router* mid-run.  Clients retry against a restarted
    router process; the restarted router has an empty ledger, so
    re-dispatched rids hit the replicas' idempotent rid caches (or
    recompute deterministically).  Passes iff every client receives
    exactly one successful completion with the expected tokens."""
    out = args.out or tempfile.mkdtemp(prefix="ptd-drill-fleet-")
    os.makedirs(out, exist_ok=True)
    n_req = max(args.steps, 8)
    kill_after, _ = drill_plan(args.seed, n_req)
    procs, urls = boot_replicas(out, "rr", (0, 1), args.seed,
                                ("--sim-itl-ms", "6.0", "--sim-prefill-ms", "0.5",
                                 "--max-batch", "2"))
    jsonl = os.path.join(out, "router-rr.jsonl")
    counter = itertools.count()

    def boot_router():
        i = next(counter)
        pf = os.path.join(out, f"router{i}.port")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytorch_distributed_tpu_torch.tools.serve_fleet",
             "router", "--replicas", f"0={urls[0]},1={urls[1]}",
             "--port-file", pf, "--metrics-jsonl", jsonl,
             "--retry-backoff-ms", "10", "--deadline-s", "30",
             "--probe-interval", "0.2", "--quarantine-backoff-ms", "50",
             "--hb-dir", os.path.join(out, "hb-rr")],
            cwd=_REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        t_end = time.monotonic() + 20.0
        while time.monotonic() < t_end and not os.path.exists(pf):
            time.sleep(0.02)
        if not os.path.exists(pf):
            proc.kill()
            raise RuntimeError("router never wrote its port file")
        with open(pf) as f:
            return proc, f"http://127.0.0.1:{int(f.read().strip())}"

    rproc, rurl = boot_router()
    holder = {"url": rurl, "proc": rproc}
    rng = random.Random(args.seed)
    prompts = [[rng.randrange(64) for _ in range(8)] for _ in range(n_req)]
    expected = [replica.sim_tokens(p, 8, 64, args.seed) for p in prompts]
    successes = [0] * n_req
    tokens_out = [None] * n_req
    lock = threading.Lock()

    def client(i: int):
        time.sleep(i * 0.004)
        t_end = time.monotonic() + 45.0
        while time.monotonic() < t_end:
            try:
                res = router.http_json("POST", holder["url"] + "/generate",
                                       {"rid": i, "prompt": prompts[i], "max_new_tokens": 8},
                                       30.0)
            except router.TRANSPORT_ERRORS:
                time.sleep(0.05)  # router down: wait for the restart
                continue
            if res.get("ok"):
                with lock:
                    successes[i] += 1
                    tokens_out[i] = res["tokens"]
                return
            time.sleep(0.05)

    killed = {"t": None}

    def killer():
        t_end = time.monotonic() + 20.0
        while time.monotonic() < t_end:
            try:
                stats = router.http_json("GET", holder["url"] + "/stats", None, 1.0)
                done = stats["stats"]["requests_completed"]
            except router.TRANSPORT_ERRORS:
                done = 0
            if done >= kill_after:
                break
            time.sleep(0.01)
        holder["proc"].send_signal(signal.SIGKILL)
        killed["t"] = time.monotonic()
        nproc, nurl = boot_router()
        holder.update(url=nurl, proc=nproc)

    print(f"drill router-restart: {n_req} requests, SIGKILL the router after completion "
          f"#{kill_after}, restart, clients replay (seed {args.seed})")
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
    kt = threading.Thread(target=killer)
    for t in threads:
        t.start()
    kt.start()
    for t in threads:
        t.join(timeout=90.0)
    kt.join(timeout=60.0)

    ok = True
    if killed["t"] is None:
        print("FAIL: the router was never killed")
        ok = False
    lost = [i for i in range(n_req) if successes[i] != 1]
    if lost:
        print(f"FAIL: request(s) {lost} did not complete exactly once "
              f"(counts {[successes[i] for i in lost]})")
        ok = False
    for i in range(n_req):
        if tokens_out[i] is not None and tokens_out[i] != expected[i]:
            print(f"FAIL: rid {i} tokens diverge across the restart")
            ok = False
            break
    computed = cache_hits = 0
    for rid in (0, 1):
        try:
            s = router.http_json("GET", urls[rid] + "/stats", None, 2.0)
            computed += int(s["computed"])
            cache_hits += int(s["cache_hits"])
        except router.TRANSPORT_ERRORS:
            print(f"FAIL: replica {rid} unreachable post-drill")
            ok = False
    if computed < n_req:
        print(f"FAIL: replicas computed {computed} < {n_req} requests")
        ok = False
    if not reqtrace.fleet_trace_records(metrics.read_metrics(jsonl)):
        print(f"FAIL: no fleettrace records in '{jsonl}'")
        ok = False
    procs["router"] = holder["proc"]
    stop_all(procs)
    if not ok:
        return 1
    print(json.dumps({"requests": n_req, "kill_after": kill_after, "computed": computed,
                      "replay_cache_hits": cache_hits,
                      "recompute_duplicates": computed - n_req,
                      "lost": 0, "double_completed": 0}, sort_keys=True))
    print("drill router-restart: every request completed exactly once across the crash, "
          "tokens bit-exact")
    print("drill router-restart: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Deterministic fault injection: the serving drills")
    ap.add_argument("--selftest", action="store_true",
                    help="not ported yet (ROADMAP.md item A11)")
    sub = ap.add_subparsers(dest="cmd")
    for name in ("corrupt", "verify", "seal"):
        c = sub.add_parser(name, help="not ported yet (ROADMAP.md item A11)")
        c.add_argument("rest", nargs=argparse.REMAINDER)
    d = sub.add_parser("drill", help="run an end-to-end drill")
    d.add_argument("kind", choices=DRILLS,
                   help="replica-kill: SIGKILL a serving replica mid-decode — every request "
                        "must complete exactly once via redispatch, tokens equal to an "
                        "unkilled run; router-restart: SIGKILL the fleet router itself — "
                        "client replays against the restarted router must land exactly once; "
                        "trace: a preemption storm whose tail attribution must name "
                        "preempt_redo and fire the preempt_redo alert live; the other kinds "
                        "are not ported yet (ROADMAP.md item A11)")
    d.add_argument("--world", type=int, default=4, help="(the mesh drills, not ported)")
    d.add_argument("--steps", type=int, default=12,
                   help="the fleet drills' request count (at least 8)")
    d.add_argument("--seed", type=int, default=0,
                   help="drives the injection point of every drill (drill_plan)")
    d.add_argument("--hang-timeout", type=float, default=1.0, help="(the hang drill, not ported)")
    d.add_argument("--device", default="cuda", help="drill trace's device: cuda (default) or cpu")
    d.add_argument("--out", metavar="DIR", default=None,
                   help="artifact directory (default: a fresh temp dir, printed)")
    args = ap.parse_args(argv)
    if args.selftest or args.cmd in ("corrupt", "verify", "seal") or (
            args.cmd == "drill" and args.kind not in SERVING_DRILLS):
        what = "--selftest" if args.selftest else (
            f"drill {args.kind}" if args.cmd == "drill" else args.cmd)
        raise SystemExit(f"chaoskit {what} is not ported to the PyTorch package yet: "
                         f"ROADMAP.md item {NOT_PORTED}")
    if args.cmd == "drill":
        return {"trace": _drill_trace, "replica-kill": _drill_replica_kill,
                "router-restart": _drill_router_restart}[args.kind](args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
