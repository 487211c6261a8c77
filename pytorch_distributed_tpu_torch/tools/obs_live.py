"""obs_live — fleet telemetry aggregator + live alert console: the twin of
the JAX repo's ``scripts/obs_live.py`` (the same dashboard, rules and exit
codes).

The read side of the live telemetry plane: every rank serves its latest
metrics record on ``--metrics-port + rank`` (obs/export.py); this CLI
scrapes those endpoints, tails the heartbeat dir, feeds both into the
*same* declarative ``AlertEngine`` the trainers run (obs/alerts.py), and
renders a terminal dashboard.  It reads files and HTTP only and never
initialises CUDA, so it runs on a host without a card.

Usage:

    # watch a 4-rank local run (ports 9100..9103), 5 s cadence
    python -m pytorch_distributed_tpu_torch.tools.obs_live --ports 9100 --world 4 \\
        --hb-dir run/hb

    # one aggregation cycle for cron/CI: exit 1 iff any alert is firing
    python -m pytorch_distributed_tpu_torch.tools.obs_live --ports 9100 --world 4 \\
        --hb-dir run/hb --once --rules rules.json --alerts-jsonl run/metrics.jsonl

``--alerts-jsonl`` books each aggregator firing as an ``alert``
ft_event into the shared JSONL (``process: -1`` marks the aggregator) —
crucially ``dead_rank``, which a killed rank can never book for itself;
goodput and ``obs_report`` fold it like any other event.

Default rules are ``alerts.default_rules()`` minus ``goodput_floor``:
a sampled scrape sees only the newest record per interval, so a
wall-span goodput estimate from scrapes would systematically undercount
productive seconds (the trainer-side engine sees every drained record
and owns that rule).

``--selftest`` exercises exposition round-trip, rule parsing, the
pseudo-record synthesis, alert booking, and the exit-code logic — no
sockets beyond localhost, CUDA never initialised (asserted).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from pytorch_distributed_tpu_torch.obs import alerts, export, heartbeat, metrics, stepattr


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


# --------------------------------------------------------------- aggregation

def aggregator_rules():
    """``default_rules()`` minus ``goodput_floor`` (see module docstring:
    sampled scrapes cannot estimate goodput honestly)."""
    return [r for r in alerts.default_rules() if r.kind != "goodput_floor"]


def endpoint_urls(args) -> list:
    """``--endpoints`` verbatim, or ``--ports BASE --world N`` expanded to
    ``http://HOST:BASE+k/metrics`` — the rank-k port convention both
    trainers use for ``--metrics-port``."""
    urls = []
    for ep in (args.endpoints or "").split(","):
        ep = ep.strip()
        if not ep:
            continue
        if not ep.startswith("http"):
            ep = f"http://{ep}"
        if not ep.rstrip("/").endswith("/metrics"):
            ep = ep.rstrip("/") + "/metrics"
        urls.append(ep)
    if args.ports is not None:
        for k in range(max(1, args.world)):
            urls.append(f"http://{args.host}:{args.ports + k}/metrics")
    return urls


def pseudo_record(samples, rank: int):
    """Synthesize a metrics-record dict from one scrape so the aggregator
    feeds the *same* ``AlertEngine.observe`` the trainers run: step-time
    stats come back from ``ptd_step_time_seconds{stat=...}``, everything
    else from the generic ``ptd_metric{field=...}`` gauges, and ``t`` is
    reconstructed from the record-age gauge."""
    rec = {"process": int(rank)}
    step = export.sample_value(samples, "ptd_step", rank=rank)
    if step is not None:
        rec["step"] = int(step)
    for field, stat in export._STAT_FIELDS.items():
        v = export.sample_value(samples, "ptd_step_time_seconds",
                                rank=rank, stat=stat)
        if v is not None:
            rec[field] = float(v)
    for name, lab, v in samples:
        if name == "ptd_metric" and lab.get("rank") == str(rank):
            rec.setdefault(lab.get("field", "?"), float(v))
    # serving gauges (ptd_serving_*, incl. the ptd_serving_attr_* request-
    # trace attribution) fold back into their record fields, so the
    # aggregator evaluates ttft_p99 / queue_wait_share / preempt_redo
    # rules from a scrape exactly like the engine does from the record
    for field, (gname, labels) in export._SERVING_FIELDS.items():
        v = export.sample_value(samples, gname, rank=rank, **labels)
        if v is not None:
            rec.setdefault(field, float(v))
    # training step-attribution gauges (ptd_attr_*) fold back
    # the same way, so the aggregator evaluates data_wait_share rules
    # from a scrape and the dashboard names each rank's bottleneck
    for field, (gname, labels) in export._ATTR_FIELDS.items():
        v = export.sample_value(samples, gname, rank=rank, **labels)
        if v is not None:
            rec.setdefault(field, float(v))
    age = export.sample_value(samples, "ptd_record_age_seconds", rank=rank)
    rec["t"] = time.time() - float(age or 0.0)
    return rec if "step_time" in rec else None


def bottleneck_of(rec):
    """Dominant step-time attribution class of a record — the largest of
    the ``attr_<component>_ms`` fields (None without ``--step-attr``)."""
    comps = {}
    for c in stepattr.COMPONENTS:
        v = rec.get(f"attr_{c}_ms")
        if v is not None:
            comps[c] = float(v)
    if not comps:
        return None
    return max(comps, key=comps.get)


def fleet_from_samples(samples):
    """Parse a fleet-router exposition (``ptd_fleet_*`` gauges,
    serving/router.py ``render_fleet_metrics``) into a dashboard dict;
    None when the endpoint is not a router."""
    if export.sample_value(samples, "ptd_fleet_up") is None:
        return None
    out = {"replicas": {}, "counters": {}, "last_scale": None}
    for name, lab, v in samples:
        if name == "ptd_fleet_replica_state":
            if v == 1.0:
                out["replicas"].setdefault(
                    lab.get("replica", "?"), {})["state"] = lab.get(
                        "state", "?")
        elif name.startswith("ptd_fleet_replica_") and "replica" in lab:
            # label-less ptd_fleet_replica_down_total is a fleet counter,
            # not a per-replica gauge — it falls through to the branch below
            field = name[len("ptd_fleet_replica_"):]
            out["replicas"].setdefault(
                lab["replica"], {})[field] = float(v)
        elif name == "ptd_fleet_last_scale":
            out["last_scale"] = lab.get("decision")
        elif name.startswith("ptd_fleet_"):
            out["counters"][name[len("ptd_fleet_"):]] = float(v)
    return out


def scraped_rank(samples):
    """The rank an exposition claims via ``ptd_up{rank=...}``."""
    for name, lab, _v in samples:
        if name == "ptd_up" and "rank" in lab:
            try:
                return int(lab["rank"])
            except ValueError:
                return None
    return None


class FleetMonitor:
    """One aggregator: scrape endpoints + read heartbeats each cycle,
    evaluate the shared rule set, optionally book firings as ``alert``
    ft_events (``process: -1``), render the dashboard."""

    def __init__(self, urls, hb_dir=None, rules=None, alerts_jsonl=None,
                 timeout: float = 2.0):
        self.urls = list(urls)
        self.hb_dir = hb_dir
        self.timeout = float(timeout)
        self.booker = None
        if alerts_jsonl:
            self.booker = metrics.MetricsLogger(alerts_jsonl,
                                                process_index=-1)
        self.engine = alerts.AlertEngine(
            rules if rules is not None else aggregator_rules(),
            emit=self._book, process_index=-1)
        self.rows = {}        # rank -> dashboard row dict
        self.remote_firing = []   # scraped ptd_alert_firing samples
        self.fleet = None     # fleet-router exposition, when scraped
        self.cycles = 0

    def _book(self, **fields) -> None:
        if self.booker is not None:
            fields = dict(fields)
            step = fields.pop("step", None)
            self.booker.log_event("alert", step=step, **fields)

    def close(self) -> None:
        if self.booker is not None:
            self.booker.close()

    # ----------------------------------------------------------- one cycle
    def cycle(self, now=None):
        """Scrape + evaluate once; returns the alerts fired this cycle."""
        now = time.time() if now is None else now
        self.cycles += 1
        fired = []
        self.remote_firing = []
        self.fleet = None
        seen = set()
        for i, url in enumerate(self.urls):
            try:
                samples = export.scrape(url, timeout=self.timeout)
            except Exception as e:
                self.rows[f"?{i}"] = {"rank": None, "url": url,
                                      "state": "DOWN", "error": str(e)}
                continue
            fl = fleet_from_samples(samples)
            if fl is not None:
                # a router endpoint: feed the fleet block, not a rank row
                self.fleet = fl
                self.rows.pop(f"?{i}", None)
                continue
            rank = scraped_rank(samples)
            rank = i if rank is None else rank
            seen.add(rank)
            self.rows.pop(f"?{i}", None)
            rec = pseudo_record(samples, rank)
            if rec is not None:
                fired += self.engine.observe(rec)
            for name, lab, _v in samples:
                if name == "ptd_alert_firing":
                    self.remote_firing.append((rank, lab.get("rule", "?"),
                                               lab.get("severity", "warn")))
            self.rows[rank] = {
                "rank": rank, "url": url, "state": "UP",
                "step": rec.get("step") if rec else None,
                "p50_ms": (rec.get("step_time_p50", 0.0) * 1e3
                           if rec else None),
                "last_ms": (rec.get("step_time", 0.0) * 1e3
                            if rec else None),
                "throughput": rec.get("throughput") if rec else None,
                "mfu": rec.get("mfu") if rec else None,
                "mem_bytes": export.sample_value(samples,
                                                 "ptd_mem_rss_bytes",
                                                 rank=rank),
                "rec_age_s": export.sample_value(
                    samples, "ptd_record_age_seconds", rank=rank),
                "alerts_total": export.sample_value(samples,
                                                    "ptd_alerts_total",
                                                    rank=rank),
                "q_share_p99": (rec.get("queue_wait_share_p99")
                                if rec else None),
                "redo_p99_ms": (rec.get("preempt_redo_ms_p99")
                                if rec else None),
                "traces": rec.get("trace_completed") if rec else None,
                "bottleneck": bottleneck_of(rec) if rec else None,
                "data_wait_share": (rec.get("data_wait_share")
                                    if rec else None),
                "host_sync_ms": (rec.get("attr_host_sync_ms")
                                 if rec else None),
            }
        beats = {}
        if self.hb_dir:
            beats = heartbeat.read_heartbeats(self.hb_dir)
            fired += self.engine.observe_heartbeats(beats, now=now)
            for pid, b in beats.items():
                row = self.rows.setdefault(pid, {"rank": pid, "url": None,
                                                 "state": "HB"})
                row["beat_age_s"] = max(0.0, now - float(b.get("t", now)))
                row.setdefault("step", b.get("step"))
        self.beats = beats
        return fired

    def quarantined_replicas(self) -> int:
        """Quarantined count off the router's own gauge — ``--once``
        exits 1 on any quarantined replica even with zero alert rules."""
        if self.fleet is None:
            return 0
        return int(self.fleet["counters"].get("quarantined", 0.0))

    def any_firing(self) -> bool:
        return bool(self.engine.active() or self.remote_firing
                    or self.quarantined_replicas())

    # ----------------------------------------------------------- rendering
    def dashboard(self, now=None) -> str:
        now = time.time() if now is None else now
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
        lines = [f"== obs_live @ {stamp} ==  cycle {self.cycles}, "
                 f"{len(self.urls)} endpoint(s)"]
        roll = heartbeat.fleet_rollup(getattr(self, "beats", {}), now=now)
        if roll:
            mem = roll.get("total_mem_bytes")
            lines.append(
                f"fleet: {roll['ranks']} rank(s)  steps "
                f"{roll['min_step']}..{roll['max_step']}  oldest beat "
                f"{roll['oldest_beat_age_s']:.1f}s"
                + (f"  median ema {roll['median_ema_s'] * 1e3:.1f}ms"
                   if roll.get("median_ema_s") is not None else "")
                + (f"  mem {mem / 2**20:.1f} MiB" if mem else ""))
        lines.append(f"{'rank':>4}  {'state':<5}  {'step':>6}  "
                     f"{'p50(ms)':>8}  {'tok/s':>8}  {'mfu':>5}  "
                     f"{'mem(MiB)':>8}  {'rec-age':>7}  {'beat-age':>8}  "
                     f"{'bottleneck':<12}")

        def _fmt(v, spec, dash="-"):
            return format(v, spec) if isinstance(v, (int, float)) else dash

        for key in sorted(self.rows, key=str):
            r = self.rows[key]
            lines.append(
                f"{_fmt(r.get('rank'), 'd', '?'):>4}  {r['state']:<5}  "
                f"{_fmt(r.get('step'), 'd'):>6}  "
                f"{_fmt(r.get('p50_ms'), '.1f'):>8}  "
                f"{_fmt(r.get('throughput'), '.0f'):>8}  "
                f"{_fmt(r.get('mfu'), '.2f'):>5}  "
                f"{_fmt((r.get('mem_bytes') or 0) / 2**20 if r.get('mem_bytes') else None, '.1f'):>8}  "
                f"{_fmt(r.get('rec_age_s'), '.1f'):>7}  "
                f"{_fmt(r.get('beat_age_s'), '.1f'):>8}  "
                f"{(r.get('bottleneck') or '-'):<12}")
        tattr = [r for _k, r in sorted(self.rows.items(), key=lambda kv:
                                       str(kv[0]))
                 if r.get("bottleneck") is not None]
        if tattr:
            lines.append("-- step attribution (where did my step go) --")
            for r in tattr:
                lines.append(
                    f"  rank {_fmt(r.get('rank'), 'd', '?')}: "
                    f"bottleneck {r['bottleneck']};  data-wait "
                    f"{_fmt(r.get('data_wait_share'), '.1f')}% of step;  "
                    f"host-sync {_fmt(r.get('host_sync_ms'), '.2f')}ms")
        attr = [r for _k, r in sorted(self.rows.items(), key=lambda kv:
                                      str(kv[0]))
                if r.get("q_share_p99") is not None
                or r.get("redo_p99_ms") is not None]
        if attr:
            lines.append("-- serving attribution (why TTFT moves) --")
            for r in attr:
                lines.append(
                    f"  rank {_fmt(r.get('rank'), 'd', '?')}: "
                    f"queue-wait share p99 "
                    f"{_fmt(r.get('q_share_p99'), '.1f')}% of TTFT;  "
                    f"preempt-redo p99 "
                    f"{_fmt(r.get('redo_p99_ms'), '.1f')}ms;  "
                    f"traces {_fmt(r.get('traces'), '.0f')}")
        if self.fleet is not None:
            c = self.fleet["counters"]

            def ct(name):
                return f"{c.get(name, 0.0):.0f}"

            lines.append("-- fleet (router) --")
            lines.append(
                f"  routed {ct('requests_total')}  completed "
                f"{ct('completed_total')}  failed {ct('failed_total')}  "
                f"retries {ct('retries_total')}  hedges "
                f"{ct('hedges_total')} (won {ct('hedges_won_total')} / "
                f"lost {ct('hedges_lost_total')})  last scale "
                f"{self.fleet['last_scale'] or 'none'}")
            lines.append(f"  {'replica':>7}  {'state':<11}  {'queue':>5}  "
                         f"{'kv%':>5}  {'ttft_p99':>9}  {'beat-age':>8}  "
                         f"{'dispatched':>10}  {'completed':>9}")
            for rid in sorted(self.fleet["replicas"], key=str):
                r = self.fleet["replicas"][rid]
                lines.append(
                    f"  {rid:>7}  {r.get('state', '?'):<11}  "
                    f"{_fmt(r.get('queue_depth'), '.0f'):>5}  "
                    f"{_fmt(r.get('kv_occupancy_pct'), '.1f'):>5}  "
                    f"{_fmt(r.get('ttft_p99_ms'), '.1f'):>7}ms  "
                    f"{_fmt(r.get('beat_age_seconds'), '.1f'):>7}s  "
                    f"{_fmt(r.get('dispatched_total'), '.0f'):>10}  "
                    f"{_fmt(r.get('completed_total'), '.0f'):>9}")
            nq = self.quarantined_replicas()
            if nq:
                lines.append(f"  {nq} replica(s) QUARANTINED")
        active = self.engine.active()
        if active:
            lines.append("-- alerts firing (aggregator) --")
            for a in sorted(active, key=lambda a: a.name):
                where = f"  rank {a.rank}" if a.rank is not None else ""
                lines.append(f"  {a.name:<16} [{a.severity}]{where}  "
                             f"{a.detail}")
        if self.remote_firing:
            lines.append("-- alerts firing (rank-local) --")
            for rank, rule, sev in sorted(set(self.remote_firing)):
                lines.append(f"  {rule:<16} [{sev}]  rank {rank}")
        if not active and not self.remote_firing:
            lines.append("no alerts firing")
        return "\n".join(lines)


# ----------------------------------------------------------------- CLI glue

def build_rules(spec):
    if spec in (None, "", "default"):
        return aggregator_rules()
    return alerts.load_rules(spec)


def run(args) -> int:
    urls = endpoint_urls(args)
    if not urls and not args.hb_dir:
        print("nothing to watch: pass --endpoints/--ports and/or --hb-dir",
              file=sys.stderr)
        return 2
    mon = FleetMonitor(urls, hb_dir=args.hb_dir,
                       rules=build_rules(args.rules),
                       alerts_jsonl=args.alerts_jsonl,
                       timeout=args.timeout)
    try:
        while True:
            fired = mon.cycle()
            print(mon.dashboard(), flush=True)
            for a in fired:
                print(f"ALERT {a.name} [{a.severity}]: {a.detail}",
                      flush=True)
            if args.once:
                return 1 if mon.any_firing() else 0
            print("", flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 130
    finally:
        mon.close()


# ------------------------------------------------------------------ selftest

def _selftest() -> int:
    """Socket-light, card-free: exposition round-trip against a real
    exporter on an ephemeral port, pseudo-record synthesis, rule
    loading, alert booking, dashboard needles, exit-code logic."""
    import tempfile
    import urllib.request

    assert not _cuda_initialized(), \
        "obs_live must never initialise CUDA (it runs on hosts without a card)"

    with tempfile.TemporaryDirectory() as d:
        # 1. Live exposition round-trip: exporter on port 0, scraped over
        #    real HTTP, pseudo-record rebuilt from the samples.
        exp = export.MetricsExporter(0, rank=3)
        exp.update({"step": 41, "t": time.time(), "process": 3,
                    "step_time": 0.020, "step_time_ema": 0.021,
                    "step_time_p50": 0.019, "step_time_p95": 0.028,
                    "step_time_max": 0.030, "throughput": 51200.0,
                    "loss": 2.5, "serving": 1.0,
                    "queue_wait_share_p99": 61.5,
                    "preempt_redo_ms_p99": 209.6,
                    "trace_completed": 24.0,
                    "attr_compute_ms": 9.0, "attr_exposed_comm_ms": 1.5,
                    "attr_host_sync_ms": 0.8, "attr_data_wait_ms": 7.7,
                    "attr_other_ms": 1.0, "attr_device_ms": 10.5,
                    "attr_comm_ms": 3.0, "attr_recon_err_ms": 0.01,
                    "data_wait_share": 38.5})
        exp.update({"ft_event": "alert", "t": time.time(), "process": 3,
                    "alert": "x", "rule": "hang", "severity": "page"})
        exp.start()
        try:
            url = f"http://127.0.0.1:{exp.port}/metrics"
            samples = export.scrape(url)
            assert export.sample_value(samples, "ptd_up", rank=3) == 1.0
            rec = pseudo_record(samples, 3)
            assert rec is not None and rec["step"] == 41
            assert abs(rec["step_time_p50"] - 0.019) < 1e-9
            assert abs(rec["throughput"] - 51200.0) < 1e-6
            assert scraped_rank(samples) == 3
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/healthz") as r:
                assert json.loads(r.read())["ok"] is True
            # ptd_serving_attr_* gauges fold back into the pseudo-record
            # so the aggregator can alert on *why* TTFT is breaching,
            # and the dashboard names the attribution per rank
            assert abs(rec["queue_wait_share_p99"] - 61.5) < 1e-9, rec
            assert abs(rec["preempt_redo_ms_p99"] - 209.6) < 1e-9, rec
            # ptd_attr_* training-attribution gauges fold back too, the
            # bottleneck column names the dominant class, and the
            # data_wait_share rule fires from a scrape like from a record
            assert abs(rec["attr_compute_ms"] - 9.0) < 1e-9, rec
            assert abs(rec["data_wait_share"] - 38.5) < 1e-9, rec
            assert bottleneck_of(rec) == "compute", rec
            mon_s = FleetMonitor([url], rules=[
                alerts.Rule("queue_wait_share", "qw", "warn",
                            {"max_pct": 50.0}),
                alerts.Rule("preempt_redo", "redo", "warn",
                            {"max_ms": 100.0}),
                alerts.Rule("data_wait_share", "dw", "warn",
                            {"max_pct": 25.0})])
            fired_s = mon_s.cycle()
            assert {a.name for a in fired_s} == {"qw", "redo", "dw"}, \
                fired_s
            assert mon_s.any_firing()
            dash_s = mon_s.dashboard()
            for needle in ("-- serving attribution", "61.5% of TTFT",
                           "preempt-redo p99 209.6ms", "traces 24",
                           "-- step attribution (where did my step go)",
                           "bottleneck compute",
                           "data-wait 38.5% of step",
                           "host-sync 0.80ms"):
                assert needle in dash_s, \
                    f"dashboard missing {needle!r}\n{dash_s}"
            assert any("UP" in ln and ln.rstrip().endswith("compute")
                       for ln in dash_s.splitlines()), \
                f"bottleneck column missing from the rank row\n{dash_s}"
        finally:
            exp.stop()

        # 2. Rules: default aggregator set drops goodput_floor; a rules
        #    file round-trips; a malformed one raises AlertRuleError.
        kinds = {r.kind for r in aggregator_rules()}
        assert "goodput_floor" not in kinds and "dead_rank" in kinds
        rp = os.path.join(d, "rules.json")
        with open(rp, "w") as f:
            json.dump({"rules": [
                {"kind": "dead_rank", "severity": "page",
                 "max_age_s": 2.0},
                {"kind": "step_time_p95", "max_ms": 15.0,
                 "quantile": "p50"}]}, f)
        loaded = build_rules(rp)
        assert [r.kind for r in loaded] == ["dead_rank", "step_time_p95"]
        bad = os.path.join(d, "bad.json")
        with open(bad, "w") as f:
            json.dump({"rules": [{"kind": "nope"}]}, f)
        try:
            build_rules(bad)
        except alerts.AlertRuleError as e:
            assert "nope" in str(e)
        else:
            raise AssertionError("malformed rules must raise")

        # 3. Heartbeat leg: a fresh rank plus a stale one → dead_rank
        #    fires, is booked to the JSONL (process -1), the dashboard
        #    names it, and --once semantics exit 1.
        hb = os.path.join(d, "hb")
        os.makedirs(hb)
        now = time.time()
        for pid, t in ((0, now), (1, now - 120.0)):
            with open(os.path.join(hb, f"heartbeat-{pid:05d}.jsonl"),
                      "w") as f:
                f.write(json.dumps({"pid": pid, "step": 10, "t": t,
                                    "world": 2, "ema": 0.02}) + "\n")
        booked = os.path.join(d, "metrics.jsonl")
        mon = FleetMonitor([], hb_dir=hb,
                           rules=[alerts.Rule("dead_rank", "dead_rank",
                                              "page",
                                              {"max_age_s": 60.0})],
                           alerts_jsonl=booked)
        fired = mon.cycle(now=now)
        assert [a.rank for a in fired] == [1], fired
        assert mon.any_firing()
        dash = mon.dashboard(now=now)
        for needle in ("== obs_live @", "fleet: 2 rank(s)", "dead_rank",
                       "[page]", "rank 1", "beat age 120.0s"):
            assert needle in dash, f"dashboard missing {needle!r}\n{dash}"
        # second cycle: latched, no re-fire, still firing
        assert mon.cycle(now=now) == []
        assert mon.any_firing()
        mon.close()
        recs = metrics.read_metrics(booked)
        assert len(recs) == 1 and recs[0]["ft_event"] == "alert"
        assert recs[0]["process"] == -1 and recs[0]["rank"] == 1
        dead = alerts.dead_ranks_from_events(recs)
        assert list(dead) == [1], \
            "a booked alert must round-trip into the dead-rank feed"

        # 4. Recovery clears the latch → exit code flips back to 0.
        with open(os.path.join(hb, "heartbeat-00001.jsonl"), "w") as f:
            f.write(json.dumps({"pid": 1, "step": 11, "t": now,
                                "world": 2, "ema": 0.02}) + "\n")
        mon2 = FleetMonitor([], hb_dir=hb,
                            rules=[alerts.Rule("dead_rank", "dead_rank",
                                               "page",
                                               {"max_age_s": 60.0})])
        assert mon2.cycle(now=now) == [] and not mon2.any_firing()
        assert "no alerts firing" in mon2.dashboard(now=now)

        # 5. DOWN endpoint: scrape failure renders, doesn't raise.
        mon3 = FleetMonitor(["http://127.0.0.1:9/metrics"], timeout=0.2)
        mon3.cycle()
        assert "DOWN" in mon3.dashboard()

        # 6. Endpoint expansion: --ports + --world, and bare host:port.
        ns = argparse.Namespace(endpoints="10.0.0.5:9100", ports=9200,
                                world=2, host="127.0.0.1")
        assert endpoint_urls(ns) == [
            "http://10.0.0.5:9100/metrics",
            "http://127.0.0.1:9200/metrics",
            "http://127.0.0.1:9201/metrics"]

        # 7. Fleet router block: a ptd_fleet_* exposition is
        #    recognized as a router (not a rank row), the dashboard grows
        #    the replica table, and one quarantined replica flips --once
        #    to exit 1 even with zero alert rules firing.
        import http.server
        import threading

        fleet_text = "\n".join([
            "ptd_fleet_up 1", "ptd_fleet_inflight 2",
            "ptd_fleet_requests_total 30",
            "ptd_fleet_completed_total 28", "ptd_fleet_failed_total 0",
            "ptd_fleet_retries_total 3", "ptd_fleet_hedges_total 4",
            "ptd_fleet_hedges_won_total 3",
            "ptd_fleet_hedges_lost_total 1",
            "ptd_fleet_duplicates_suppressed_total 0",
            "ptd_fleet_replica_down_total 1",
            'ptd_fleet_last_scale{decision="up:replica2"} 1',
            "ptd_fleet_replicas 2", "ptd_fleet_quarantined 1",
            'ptd_fleet_replica_state{replica="0",state="UP"} 1',
            'ptd_fleet_replica_queue_depth{replica="0"} 2',
            'ptd_fleet_replica_kv_occupancy_pct{replica="0"} 50',
            'ptd_fleet_replica_ttft_p99_ms{replica="0"} 88.5',
            'ptd_fleet_replica_beat_age_seconds{replica="0"} 0.4',
            'ptd_fleet_replica_dispatched_total{replica="0"} 20',
            'ptd_fleet_replica_completed_total{replica="0"} 18',
            'ptd_fleet_replica_state{replica="1",state="QUARANTINED"} 1',
            'ptd_fleet_replica_dispatched_total{replica="1"} 10',
            'ptd_fleet_replica_completed_total{replica="1"} 10',
        ]) + "\n"

        class _FleetHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = fleet_text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                              _FleetHandler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            mon_f = FleetMonitor(
                [f"http://127.0.0.1:{srv.server_port}/metrics"], rules=[])
            assert mon_f.cycle() == []
            assert mon_f.fleet is not None, "router exposition missed"
            assert not mon_f.rows, \
                "a router endpoint must not masquerade as a rank row"
            assert sorted(mon_f.fleet["replicas"]) == ["0", "1"], \
                "label-less replica_down_total must not fabricate a row"
            assert mon_f.fleet["counters"]["replica_down_total"] == 1.0
            assert mon_f.quarantined_replicas() == 1
            assert mon_f.any_firing(), \
                "--once must exit 1 on a quarantined replica"
            dash_f = mon_f.dashboard()
            for needle in ("-- fleet (router) --",
                           "routed 30  completed 28",
                           "retries 3  hedges 4 (won 3 / lost 1)",
                           "last scale up:replica2",
                           "QUARANTINED", "88.5ms",
                           "1 replica(s) QUARANTINED"):
                assert needle in dash_f, \
                    f"fleet dashboard missing {needle!r}\n{dash_f}"
            # healthy fleet: same shape, nothing quarantined -> exit 0
            fleet_text = fleet_text.replace(
                "ptd_fleet_quarantined 1", "ptd_fleet_quarantined 0")
            mon_ok = FleetMonitor(
                [f"http://127.0.0.1:{srv.server_port}/metrics"], rules=[])
            mon_ok.cycle()
            assert not mon_ok.any_firing()
        finally:
            srv.shutdown()

    assert not _cuda_initialized()
    print("obs_live selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fleet telemetry aggregator: scrape per-rank metric "
                    "exporters, tail heartbeats, evaluate alert rules")
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated exporter endpoints "
                         "(host:port or full /metrics URLs)")
    ap.add_argument("--ports", type=int, default=None, metavar="BASE",
                    help="scrape http://HOST:BASE+k/metrics for "
                         "k in [0, --world)")
    ap.add_argument("--world", type=int, default=1,
                    help="rank count for --ports expansion")
    ap.add_argument("--host", default="127.0.0.1",
                    help="host for --ports expansion")
    ap.add_argument("--hb-dir", default=None, dest="hb_dir",
                    help="heartbeat dir (dead/slow-rank rules + fleet "
                         "rollup)")
    ap.add_argument("--rules", default=None, metavar="RULES",
                    help="alert rules JSON, or 'default' (default set "
                         "minus goodput_floor)")
    ap.add_argument("--alerts-jsonl", default=None, dest="alerts_jsonl",
                    metavar="PATH",
                    help="book aggregator firings as alert ft_events "
                         "into this metrics JSONL (process -1)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="seconds between aggregation cycles")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint scrape timeout")
    ap.add_argument("--once", action="store_true",
                    help="one cycle for cron/CI: exit 1 iff any alert "
                         "is firing")
    ap.add_argument("--selftest", action="store_true",
                    help="run the aggregator's own checks (no card needed)")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
