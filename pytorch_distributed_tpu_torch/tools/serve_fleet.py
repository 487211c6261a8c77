"""Resilient serving fleet CLI: replicas, router, arbiter, bench — the twin
of the JAX package's ``scripts/serve_fleet.py`` over the port's
``serving/{replica,router}.py``.

Subcommands:

- ``replica`` — boot one serving replica (deterministic torch-free sim
  backend by default; ``--engine`` runs the port's ``ServingEngine`` on
  ``--device``, ``cuda`` unless ``cpu`` is asked for).  Beats heartbeats
  into ``--hb-dir``, serves ``/generate`` ``/healthz`` ``/metrics``
  ``/drain`` ``/cancel``, and writes its bound port to ``--port-file`` so
  parents can find an ephemeral-port replica.
- ``router`` — health-checked least-loaded router over N replicas with
  deadline-budgeted retries, optional tail hedging, a completion ledger
  (exactly-once), graceful ``/drain``, and ``ptd_fleet_*`` gauges.
- ``arbiter`` — elastic replica-set arbiter: evicts dead replicas through
  ``ft/elastic.py``'s membership protocol and grows/shrinks against
  measured SLO headroom, booking scale events as ft_events.
- ``bench`` — the Poisson scaling harness: boots fleets of 1..N sim
  replicas behind a router, drives the same arrival process at each size,
  and prints the tokens/s scaling; ``--out`` writes it as JSON to a path
  the caller names (never a ``RESULTS_*.json`` of the repo root).

    python -m pytorch_distributed_tpu_torch.tools.serve_fleet --selftest
    python -m pytorch_distributed_tpu_torch.tools.serve_fleet replica --engine --device cpu \
        --replica-id 0 --port-file /tmp/p0 --hb-dir /tmp/hb
    python -m pytorch_distributed_tpu_torch.tools.serve_fleet router \
        --replicas 0=http://127.0.0.1:$(cat /tmp/p0) --port-file /tmp/pr

Torch-free except for ``replica --engine`` (``--selftest`` asserts it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

from pytorch_distributed_tpu_torch.obs import alerts, export, metrics, reqtrace
from pytorch_distributed_tpu_torch.serving import replica, router

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve_fleet",
        description="resilient serving fleet: replicas, router, arbiter")
    p.add_argument("--selftest", action="store_true",
                   help="run the torch-free fleet selftest and exit")
    sub = p.add_subparsers(dest="cmd")

    r = sub.add_parser("replica", help="boot one serving replica")
    r.add_argument("--replica-id", type=int, default=0)
    r.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral; see --port-file")
    r.add_argument("--port-file", default="",
                   help="write the bound port here once listening")
    r.add_argument("--hb-dir", default="",
                   help="heartbeat directory (fleet membership)")
    r.add_argument("--hb-interval", type=float, default=1.0)
    r.add_argument("--epoch", type=int, default=0)
    r.add_argument("--metrics-jsonl", default="")
    r.add_argument("--engine", action="store_true",
                   help="the port's ServingEngine backend (imports torch)")
    r.add_argument("--device", default="cuda",
                   help="--engine's device: cuda (default) or cpu")
    r.add_argument("--req-trace", action="store_true",
                   help="arm --engine's per-request tracer: its reqtrace records "
                        "go to --metrics-jsonl (the sim backend books them whenever "
                        "--metrics-jsonl is set)")
    r.add_argument("--vocab-size", type=int, default=64)
    r.add_argument("--max-batch", type=int, default=4)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--slo-ttft-ms", type=float, default=0.0)
    r.add_argument("--sim-itl-ms", type=float, default=2.0,
                   help="sim backend per-token latency")
    r.add_argument("--sim-prefill-ms", type=float, default=0.2,
                   help="sim backend prefill cost per prompt token")
    r.add_argument("--d-model", type=int, default=32)
    r.add_argument("--n-heads", type=int, default=4)
    r.add_argument("--n-layers", type=int, default=2)
    r.add_argument("--kv-blocks", type=int, default=64)
    r.add_argument("--block-size", type=int, default=16)
    r.add_argument("--blocks-per-seq", type=int, default=8)
    r.add_argument("--chunk-size", type=int, default=8)
    r.add_argument("--max-new-tokens", type=int, default=16)

    t = sub.add_parser("router", help="boot the fleet router")
    t.add_argument("--port", type=int, default=0)
    t.add_argument("--port-file", default="")
    t.add_argument("--replicas", default="",
                   help="comma list of id=url (e.g. 0=http://127.0.0.1:8100)")
    t.add_argument("--hb-dir", default="")
    t.add_argument("--metrics-jsonl", default="")
    t.add_argument("--deadline-s", type=float, default=30.0)
    t.add_argument("--max-retries", type=int, default=2)
    t.add_argument("--retry-backoff-ms", type=float, default=50.0)
    t.add_argument("--retry-jitter", type=float, default=0.5)
    t.add_argument("--hedge", action="store_true",
                   help="arm tail hedging (p95-derived delay)")
    t.add_argument("--hedge-quantile", type=float, default=0.95)
    t.add_argument("--hedge-min-ms", type=float, default=20.0)
    t.add_argument("--probe-interval", type=float, default=1.0)
    t.add_argument("--probe-timeout", type=float, default=2.0)
    t.add_argument("--quarantine-backoff-ms", type=float, default=500.0)
    t.add_argument("--quarantine-backoff-max-s", type=float, default=30.0)
    t.add_argument("--max-beat-age", type=float, default=60.0)
    t.add_argument("--seed", type=int, default=0)

    a = sub.add_parser("arbiter", help="elastic replica-set arbiter")
    a.add_argument("--replicas", default="")
    a.add_argument("--hb-dir", required=True)
    a.add_argument("--metrics-jsonl", default="")
    a.add_argument("--slo-ttft-ms", type=float, default=500.0)
    a.add_argument("--min-replicas", type=int, default=1)
    a.add_argument("--max-replicas", type=int, default=8)
    a.add_argument("--scale-up-pct", type=float, default=85.0)
    a.add_argument("--scale-down-pct", type=float, default=30.0)
    a.add_argument("--interval", type=float, default=5.0)
    a.add_argument("--once", action="store_true",
                   help="one arbiter cycle, then exit (cron idiom)")
    a.add_argument("--spawn-cmd", default="",
                   help="shell template to boot a new replica; {rid} and "
                        "{port_file} are substituted")

    b = sub.add_parser("bench", help="Poisson replica-scaling harness")
    b.add_argument("--fleet-sizes", default="1,2",
                   help="comma list of replica counts to bench")
    b.add_argument("--requests", type=int, default=64)
    b.add_argument("--rate-rps", type=float, default=400.0)
    b.add_argument("--max-new-tokens", type=int, default=8)
    b.add_argument("--prompt-len", type=int, default=8)
    b.add_argument("--sim-itl-ms", type=float, default=5.0)
    b.add_argument("--sim-prefill-ms", type=float, default=0.5)
    b.add_argument("--max-batch", type=int, default=2)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--min-scaling", type=float, default=0.8,
                   help="fence: tokens/s scaling ratio vs linear")
    b.add_argument("--out", default="",
                   help="write the bench JSON here (a path the caller "
                        "names; never a RESULTS_*.json of the repo root)")
    return p


def parse_replicas(spec: str):
    """``"0=http://h:p,1=http://h:q"`` → ``{0: url, 1: url}`` (bare urls
    get sequential ids)."""
    out = {}
    for i, part in enumerate(x for x in spec.split(",") if x.strip()):
        part = part.strip()
        if "=" in part:
            rid, url = part.split("=", 1)
            out[int(rid)] = url
        else:
            out[i] = part
    return out


def _write_port_file(path: str, port: int) -> None:
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


def _make_obs(path: str, process_index: int):
    if not path:
        return None
    return metrics.MetricsLogger(path, process_index=process_index,
                                 flush_every=1)


# ---------------------------------------------------------------------------
# subcommands


def cmd_replica(args) -> int:
    obs = _make_obs(args.metrics_jsonl, args.replica_id)
    if args.engine:
        backend = replica.EngineBackend(
            replica_id=args.replica_id, vocab_size=args.vocab_size,
            d_model=args.d_model, n_heads=args.n_heads,
            n_layers=args.n_layers, max_batch=args.max_batch,
            kv_blocks=args.kv_blocks, block_size=args.block_size,
            blocks_per_seq=args.blocks_per_seq, chunk_size=args.chunk_size,
            max_new_tokens=args.max_new_tokens, seed=args.seed, obs=obs,
            trace=(reqtrace.ReqTracer(sample=1.0, hop=f"engine:{args.replica_id}")
                   if args.req_trace else None),
            device=args.device)
    else:
        backend = replica.SimEngineBackend(
            replica_id=args.replica_id, vocab_size=args.vocab_size,
            max_batch=args.max_batch,
            prefill_ms_per_token=args.sim_prefill_ms,
            itl_ms=args.sim_itl_ms, seed=args.seed,
            slo_ttft_ms=args.slo_ttft_ms or None, obs=obs)
    srv = replica.ReplicaServer(
        backend, replica_id=args.replica_id, port=args.port,
        hb_dir=args.hb_dir or None, hb_interval_s=args.hb_interval,
        epoch=args.epoch)
    srv.start()
    _write_port_file(args.port_file, srv.port)
    print(f"replica {args.replica_id} listening on {srv.url}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        if obs is not None:
            obs.close()
    return 0


def _build_router(args, replicas):
    obs = _make_obs(args.metrics_jsonl, -2)
    alert_engine = None
    if obs is not None:
        alert_engine = alerts.AlertEngine(
            [alerts.Rule(kind="replica_down", name="replica_down",
                         severity="page", params={})],
            emit=lambda **f: obs.log_event("alert", **f),
            process_index=-2)
    registry = router.ReplicaRegistry(
        replicas, hb_dir=args.hb_dir or None,
        probe_timeout=args.probe_timeout,
        backoff_initial_s=args.quarantine_backoff_ms / 1000.0,
        backoff_max_s=args.quarantine_backoff_max_s,
        max_beat_age_s=args.max_beat_age)
    policy = router.RouterPolicy(
        deadline_s=args.deadline_s, max_retries=args.max_retries,
        retry_backoff_s=args.retry_backoff_ms / 1000.0,
        retry_jitter=args.retry_jitter, hedge=args.hedge,
        hedge_quantile=args.hedge_quantile,
        hedge_min_s=args.hedge_min_ms / 1000.0, seed=args.seed)
    rt = router.FleetRouter(registry, policy, obs=obs,
                            alert_engine=alert_engine, port=args.port,
                            probe_interval_s=args.probe_interval)
    return rt, obs


def cmd_router(args) -> int:
    replicas = parse_replicas(args.replicas)
    if not replicas:
        print("router: no replicas given (--replicas)", file=sys.stderr)
        return 2
    rt, obs = _build_router(args, replicas)
    rt.registry.probe()
    rt.start()
    _write_port_file(args.port_file, rt.port)
    print(f"router listening on {rt.url} over {len(replicas)} replicas",
          flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        rt.stop()
        if obs is not None:
            obs.close()
    return 0


def _spawn_from_template(template: str, hb_dir: str):
    """Build a ``spawn_cb`` that boots a replica from a shell template
    and returns its url once the port file lands."""
    def spawn(rid: int):
        port_file = os.path.join(hb_dir, f"replica-{rid:05d}.port")
        try:
            os.remove(port_file)
        except OSError:
            pass
        cmd = template.format(rid=rid, port_file=port_file)
        subprocess.Popen(cmd, shell=True)
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end:
            if os.path.exists(port_file):
                with open(port_file) as f:
                    return f"http://127.0.0.1:{int(f.read().strip())}"
            time.sleep(0.05)
        return None
    return spawn


def cmd_arbiter(args) -> int:
    obs = _make_obs(args.metrics_jsonl, -3)
    registry = router.ReplicaRegistry(parse_replicas(args.replicas),
                                      hb_dir=args.hb_dir)
    spawn_cb = (_spawn_from_template(args.spawn_cmd, args.hb_dir)
                if args.spawn_cmd else None)

    def drain_cb(rid: int) -> bool:
        rep = registry.replicas.get(rid)
        if rep is None:
            return True
        try:
            res = router.http_json("POST", rep.base_url + "/drain",
                                   {"wait": True}, 30.0)
            return bool(res.get("drained", res.get("draining")))
        except router.TRANSPORT_ERRORS:
            return True  # already dead counts as drained

    arb = router.FleetArbiter(
        registry, args.hb_dir, slo_ttft_ms=args.slo_ttft_ms,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        scale_up_pct=args.scale_up_pct, scale_down_pct=args.scale_down_pct,
        obs=obs, spawn_cb=spawn_cb, drain_cb=drain_cb)
    try:
        while True:
            decision, reason = arb.cycle()
            m = arb.co.membership()
            print(f"arbiter: epoch {m.epoch} world {m.world} "
                  f"decision={decision or 'hold'}: {reason}", flush=True)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if obs is not None:
            obs.close()


# ---------------------------------------------------------------------------
# bench: Poisson replica-scaling harness


def _poisson_arrivals(n: int, rate_rps: float, seed: int):
    import random as _random
    rng = _random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(t)
    return out


def _drive_fleet(n_replicas: int, args):
    """Boot n sim replicas + router in-process, drive the Poisson load
    over HTTP, and measure fleet tokens/s over the makespan."""
    import random as _random
    reps, urls = [], {}
    for rid in range(n_replicas):
        backend = replica.SimEngineBackend(
            replica_id=rid, max_batch=args.max_batch,
            prefill_ms_per_token=args.sim_prefill_ms,
            itl_ms=args.sim_itl_ms, seed=args.seed)
        srv = replica.ReplicaServer(backend, replica_id=rid)
        srv.start()
        reps.append(srv)
        urls[rid] = srv.url
    registry = router.ReplicaRegistry(urls)
    rt = router.FleetRouter(registry,
                            router.RouterPolicy(deadline_s=60.0, seed=args.seed))
    registry.probe()
    rt.start()

    rng = _random.Random(args.seed)
    prompts = [[rng.randrange(64) for _ in range(args.prompt_len)]
               for _ in range(args.requests)]
    arrivals = _poisson_arrivals(args.requests, args.rate_rps, args.seed)
    results = [None] * args.requests
    lock = threading.Lock()

    def fire(i: int, t0: float):
        delay = t0 + arrivals[i] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        res = router.http_json("POST", rt.url + "/generate",
                               {"rid": i, "prompt": prompts[i],
                                "max_new_tokens": args.max_new_tokens}, 120.0)
        with lock:
            results[i] = res

    t0 = time.monotonic()
    threads = [threading.Thread(target=fire, args=(i, t0), daemon=True)
               for i in range(args.requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
    wall = time.monotonic() - t0
    ok = [r for r in results if r and r.get("ok")]
    tokens = sum(len(r["tokens"]) for r in ok)
    ttfts = sorted(r["router_ttft_ms"] for r in ok)
    out = {"replicas": n_replicas, "completed": len(ok),
           "requests": args.requests, "wall_s": round(wall, 3),
           "tokens": tokens, "tokens_per_s": round(tokens / wall, 2),
           "ttft_p99_ms": round(
               ttfts[min(len(ttfts) - 1, int(0.99 * len(ttfts)))], 2)
           if ttfts else None,
           "retries": rt.stats.as_dict()["retries"]}
    rt.stop()
    for srv in reps:
        srv.stop()
    return out


def cmd_bench(args) -> int:
    if args.out and os.path.basename(args.out).startswith("RESULTS_") and (
            os.path.dirname(os.path.abspath(args.out)) == _REPO):
        print(f"bench: refusing to write {args.out}: the repo root's RESULTS_*.json "
              "are the JAX package's records", file=sys.stderr)
        return 2
    sizes = sorted({int(x) for x in args.fleet_sizes.split(",") if x.strip()})
    runs = []
    for n in sizes:
        run = _drive_fleet(n, args)
        print(f"bench: {n} replica(s): {run['tokens_per_s']} tokens/s "
              f"({run['completed']}/{run['requests']} completed, "
              f"ttft_p99 {run['ttft_p99_ms']} ms)", flush=True)
        runs.append(run)
    base = next((r for r in runs if r["replicas"] == min(sizes)), None)
    scaling = None
    if base and len(runs) > 1:
        top = runs[-1]
        linear = base["tokens_per_s"] * top["replicas"] / base["replicas"]
        scaling = round(top["tokens_per_s"] / linear, 3)
        print(f"bench: scaling {scaling}x of linear at "
              f"{top['replicas']} replicas (fence >= {args.min_scaling})",
              flush=True)
    result = {"bench": "fleet_scaling", "runs": runs,
              "scaling_vs_linear": scaling,
              "min_scaling_fence": args.min_scaling,
              "all_completed": all(r["completed"] == r["requests"]
                                   for r in runs)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    if not result["all_completed"]:
        print("FAIL: bench lost requests", file=sys.stderr)
        return 1
    if scaling is not None and scaling < args.min_scaling:
        print(f"FAIL: scaling {scaling} < fence {args.min_scaling}",
              file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# selftest


def _selftest() -> int:  # noqa: C901
    import tempfile
    assert "torch" not in sys.modules, "selftest must start torch-free"
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"FAIL: {msg}")

    # 1. deterministic sim decode: pure function of (prompt, seed).
    p = [3, 1, 4, 1, 5]
    check(replica.sim_tokens(p, 8, 64, 7) == replica.sim_tokens(p, 8, 64, 7),
          "sim_tokens not deterministic")
    check(replica.sim_tokens(p, 8, 64, 7) != replica.sim_tokens(p, 8, 64, 8),
          "sim_tokens ignores seed")

    with tempfile.TemporaryDirectory() as td:
        jsonl = os.path.join(td, "router.jsonl")
        hb_dir = os.path.join(td, "hb")
        obs = metrics.MetricsLogger(jsonl, process_index=-2, flush_every=1)

        def boot(rid):
            backend = replica.SimEngineBackend(
                replica_id=rid, max_batch=2, prefill_ms_per_token=0.05,
                itl_ms=0.5, seed=0)
            srv = replica.ReplicaServer(backend, replica_id=rid,
                                        hb_dir=hb_dir, hb_interval_s=0.2)
            srv.start()
            return srv

        r0, r1 = boot(0), boot(1)
        registry = router.ReplicaRegistry(
            {0: r0.url, 1: r1.url}, hb_dir=hb_dir,
            backoff_initial_s=0.05, probe_timeout=1.0)
        rt = router.FleetRouter(
            registry, router.RouterPolicy(deadline_s=10.0, max_retries=2,
                                          retry_backoff_s=0.01),
            obs=obs, probe_interval_s=0.2)
        registry.probe()
        check(len(registry.up()) == 2, "both replicas should probe UP")
        check(registry.replicas[0].queue_depth is not None,
              "probe should scrape serving gauges")

        # 2. dispatch: every request completes with the sim-exact tokens.
        for rid in range(6):
            code, res = rt.submit({"rid": rid, "prompt": p,
                                   "max_new_tokens": 6})
            check(code == 200 and res["ok"], f"rid {rid} failed: {res}")
            check(res["tokens"] == replica.sim_tokens(p, 6, 64, 0),
                  f"rid {rid} tokens not sim-exact")
        check(len(rt.ledger) == 6, "ledger should hold 6 completions")

        # 3. one trace spans router -> engine -> completion.
        code, res = rt.submit({"rid": 10, "prompt": p, "max_new_tokens": 4})
        hops = res["ctx"]["hops"]
        for needle in ("router:recv", "dispatch:replica", ":recv", "queue",
                       "admit", "finish", "router:done"):
            check(any(needle in h for h in hops),
                  f"trace hop chain missing {needle!r}: {hops}")

        # 4. idempotent replay: same rid returns the original bit-for-bit.
        code, replay = rt.submit({"rid": 10, "prompt": p,
                                  "max_new_tokens": 4})
        check(replay.get("replayed") and replay["tokens"] == res["tokens"],
              "replay should return the cached completion")
        check(rt.stats.as_dict()["duplicates_suppressed"] >= 1,
              "replay should count as suppressed duplicate")

        # 5. replica death: quarantine + redispatch, nothing lost.
        r1.stop()
        registry.probe()
        check(registry.replicas[1].state == router.QUARANTINED,
              "dead replica should be QUARANTINED")
        back0 = registry.replicas[1].backoff_s
        registry.replicas[1].next_probe_t = 0.0
        registry.probe()
        check(registry.replicas[1].backoff_s > back0,
              "quarantine re-probe backoff should grow")
        for rid in range(20, 26):
            code, res = rt.submit({"rid": rid, "prompt": p,
                                   "max_new_tokens": 6})
            check(code == 200 and res["ok"] and res["replica"] == 0,
                  f"rid {rid} should complete on the survivor")
        obs_records = metrics.read_metrics(jsonl)
        downs = [r for r in obs_records
                 if r.get("ft_event") == "replica_down"]
        check(len(downs) >= 1, "replica_down ft_event should be booked")
        fleettraces = [r for r in obs_records
                       if r.get("ft_event") == "fleettrace"]
        check(len(fleettraces) >= 7, "fleettrace events should be booked")
        # attribution decomposition is exact by construction.
        for ftr in fleettraces:
            lhs = ftr["router_ttft_ms"]
            rhs = (ftr["router_wait_ms"] + ftr["redispatch_ms"]
                   + ftr["hedge_wait_ms"] + ftr["engine_ttft_ms"])
            check(abs(lhs - rhs) < 1e-6,
                  f"router attribution not exact: {lhs} vs {rhs}")

        # 6. hedging: a slow primary is beaten by the hedge.
        hrt = router.FleetRouter(
            registry,
            router.RouterPolicy(deadline_s=5.0, hedge=True,
                                hedge_min_s=0.01, hedge_floor_samples=2))
        hrt._latency_ms.extend([5.0] * 4)

        def fake_call(rep, payload, ctx, timeout):
            if rep.rid == 0:
                time.sleep(0.25)
                return True, {"ok": True, "rid": payload["rid"],
                              "tokens": [1], "ttft_ms": 250.0,
                              "e2e_ms": 250.0, "replica": 0}
            return True, {"ok": True, "rid": payload["rid"], "tokens": [1],
                          "ttft_ms": 1.0, "e2e_ms": 1.0, "replica": 1}

        hrt._call_replica = fake_call
        registry.replicas[1].state = router.UP
        code, res = hrt.submit({"rid": 50, "prompt": p, "max_new_tokens": 1})
        d = hrt.stats.as_dict()
        check(code == 200 and res["ok"], "hedged request should complete")
        check(d["hedges"] == 1 and d["hedges_won"] == 1,
              f"hedge should launch and win: {d}")
        check(res["replica"] == 1 and res["hedged"],
              "winner should be the hedge replica")

        # 7. graceful drain: replica refuses new work, finishes in-flight.
        res = r0.handle_drain(wait=True, timeout_s=2.0)
        check(res["drained"], "drain should settle with no in-flight")
        registry.probe()
        check(registry.replicas[0].state == router.DRAINING,
              "draining replica should probe DRAINING")
        check(registry.pick() is None,
              "pick must exclude DRAINING replicas")
        rt.drain()
        code, res = rt.submit({"rid": 60, "prompt": p, "max_new_tokens": 2})
        check(code == 503, "draining router must refuse admission")

        # 8. scale decisions are pure and directional.
        rows_hot = [{"rid": 0, "state": "UP", "ttft_p99_ms": 480.0,
                     "queue_depth": 2.0, "inflight": 1}]
        rows_cold = [{"rid": i, "state": "UP", "ttft_p99_ms": 20.0,
                      "queue_depth": 0.0, "inflight": 0} for i in range(2)]
        d, v, _ = router.decide_scale(rows_hot, slo_ttft_ms=500.0)
        check(d == "up", "hot fleet should scale up")
        d, v, _ = router.decide_scale(rows_cold, slo_ttft_ms=500.0)
        check(d == "down" and v in (0, 1), "cold fleet should scale down")
        d, v, _ = router.decide_scale(rows_cold[:1], slo_ttft_ms=500.0)
        check(d is None, "min_replicas floor must refuse scale-down")

        # 9. arbiter: eviction through the one membership path + booked
        # scale events.
        arb_jsonl = os.path.join(td, "arbiter.jsonl")
        arb_obs = metrics.MetricsLogger(arb_jsonl, process_index=-3,
                                        flush_every=1)
        r2 = boot(2)
        areg = router.ReplicaRegistry(
            {2: r2.url, 3: "http://127.0.0.1:1"},  # 3 is dead
            hb_dir=hb_dir, backoff_initial_s=0.01, probe_timeout=0.3)
        arb = router.FleetArbiter(
            areg, hb_dir, slo_ttft_ms=500.0, min_replicas=1,
            max_replicas=4, obs=arb_obs, dead_failures=1,
            spawn_cb=lambda rid: None)
        check(arb.co.membership().world >= 1, "membership should exist")
        areg.probe()
        areg.replicas[3].next_probe_t = 0.0
        areg.probe()  # second failure -> eligible for eviction
        arb.cycle()
        check(3 not in arb.co.membership().ranks,
              "dead replica must be evicted from membership")
        # force a scale-up: pretend headroom is exhausted.
        arb.scale_up_pct = -1.0
        r3 = boot(4)
        arb.spawn_cb = lambda rid: r3.url
        decision, reason = arb.cycle()
        check(decision == "up", f"forced scale-up expected: {reason}")
        check(arb.stats.as_dict()["scale_up_events"] == 1,
              "scale_up should be counted")
        arb_records = metrics.read_metrics(arb_jsonl)
        kinds = {r.get("ft_event") for r in arb_records}
        check("replica_evict" in kinds and "scale_up" in kinds,
              f"arbiter should book eviction + scale ft_events: {kinds}")

        # 10. fleet gauges render and parse.
        samples = export.parse_prometheus(rt.render_metrics())
        check(export.sample_value(samples, "ptd_fleet_replicas") == 2.0,
              "fleet gauge ptd_fleet_replicas should render")
        check(export.sample_value(samples, "ptd_fleet_completed_total") >= 13,
              "fleet completions gauge should count")
        stray = {name for name, _lab, _v in samples
                 if name not in export.FLEET_GAUGES}
        check(not stray,
              f"rendered gauges missing from export.FLEET_GAUGES: {stray}")

        rt.stop()
        hrt.stop()
        for srv in (r0, r2, r3):
            srv.stop()
        obs.close()
        arb_obs.close()

    assert "torch" not in sys.modules, "fleet selftest must stay torch-free"
    if failures:
        print(f"serve_fleet selftest: {len(failures)} failure(s)")
        return 1
    print("serve_fleet selftest: OK")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.selftest:
        return _selftest()
    if args.cmd == "replica":
        return cmd_replica(args)
    if args.cmd == "router":
        return cmd_router(args)
    if args.cmd == "arbiter":
        return cmd_arbiter(args)
    if args.cmd == "bench":
        return cmd_bench(args)
    build_parser().print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
