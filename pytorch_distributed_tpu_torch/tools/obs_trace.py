"""obs_trace — per-request serving-trace analyzer: the twin of the JAX
package's ``scripts/obs_trace.py`` (the same report, JSON and Perfetto
output).

Reads the ``reqtrace`` ft_events the serving engine books into the
metrics JSONL (``serve_lm --req-trace --metrics-jsonl ...``, recorder in
obs/reqtrace.py) and answers the question the aggregate quantiles can't:
*where did the TTFT tail come from?*  A JSONL that also holds the fleet
router's ``fleettrace`` events gets the fleet reconciliation section.

    # human report: per-component attribution + tail rollup + slowest
    python -m pytorch_distributed_tpu_torch.tools.obs_trace --metrics-jsonl /tmp/serve.jsonl

    # machine form; recount SLO violations against a different target
    python -m pytorch_distributed_tpu_torch.tools.obs_trace --metrics-jsonl /tmp/serve.jsonl \
        --json --slo-ms 250

    # standalone Perfetto file of the per-request tracks
    python -m pytorch_distributed_tpu_torch.tools.obs_trace --metrics-jsonl /tmp/serve.jsonl \
        --perfetto /tmp/req.json

Runs with **no torch in the process** (obs/reqtrace.py and obs/metrics.py
import none); ``--selftest`` asserts it and round-trips the committed
fixture ``tests/data/reqtrace_fixture.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pytorch_distributed_tpu_torch.obs import metrics, reqtrace

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE = os.path.join(_REPO, "tests", "data", "reqtrace_fixture.jsonl")


# ------------------------------------------------------------------ analysis

def analyze(path: str, slo_ms=None):
    """Parse the JSONL, optionally re-judge violations against
    ``slo_ms``, and return (records, attribution summary dict)."""
    records = metrics.read_metrics(path)
    trs = reqtrace.trace_records(records)
    if slo_ms is not None:
        for r in trs:
            r["violated"] = 1 if float(r.get("ttft_ms", 0)) > slo_ms else 0
    return trs, reqtrace.attribution_summary(trs)


def analyze_fleet(path: str):
    """Fleet-router reconciliation: the per-request
    ``fleettrace`` events checked against the decomposition identity and
    — when the same JSONL holds the replicas' ``reqtrace`` events — the
    engine's own TTFT.  None for routerless runs."""
    records = metrics.read_metrics(path)
    ftrs = reqtrace.fleet_trace_records(records)
    return ftrs, reqtrace.fleet_reconciliation(
        ftrs, reqtrace.trace_records(records))


def render_fleet(frec) -> str:
    lines = ["== fleet routing =="]
    if frec is None:
        return ""
    lines.append(
        f"requests {frec['requests']}  retried {frec['retried']}  "
        f"hedged {frec['hedged']}  router ttft p99 "
        f"{frec['router_ttft_p99_ms']:.1f}ms  router wait p99 "
        f"{frec['router_wait_p99_ms']:.1f}ms")
    lines.append(
        f"decomposition err max {frec['decomp_err_ms_max']:.4f}ms "
        "(router_ttft == router_wait + redispatch + hedge_wait "
        "+ engine_ttft)")
    if frec["engine_matched"]:
        lines.append(
            f"engine echo: {frec['engine_matched']} request(s) matched "
            f"to reqtrace; err max "
            f"{frec['engine_echo_err_ms_max']:.4f}ms")
    else:
        lines.append("engine echo: no matching reqtrace events in this "
                     "JSONL (replicas log to their own files)")
    return "\n".join(lines)


def render(summ, trs, slo_ms=None) -> str:
    lines = ["== request traces =="]
    if summ is None:
        lines.append("no reqtrace events (run serve_lm --req-trace)")
        return "\n".join(lines)
    lines.append(
        f"requests {summ['requests']}  violations {summ['violations']}"
        + (f" (slo {slo_ms:g}ms)" if slo_ms is not None else "")
        + f"  spans kept {summ['sampled_kept']}"
          f"  spans dropped {summ['spans_dropped']}"
          f"  preemptions {summ['preemptions']}")
    lines.append(
        f"ttft p50 {summ['ttft_p50_ms']:.1f}ms  "
        f"p99 {summ['ttft_p99_ms']:.1f}ms  "
        f"e2e p99 {summ['e2e_p99_ms']:.1f}ms  "
        f"recon err max {summ['recon_err_ms_max']:.3f}ms")
    lines.append(
        f"queue_wait_share_p99 {summ['queue_wait_share_p99']:.1f}%  "
        f"preempt_redo_ms_p99 {summ['preempt_redo_ms_p99']:.1f}ms")
    tail = summ.get("tail")
    if tail:
        lines.append("tail attribution: " + reqtrace.format_tail_line(tail))
        lines.append(f"dominant tail component: {tail['dominant']}")
    slow = sorted(trs, key=lambda r: -float(r.get("ttft_ms", 0)))[:5]
    if slow:
        lines.append("slowest requests (ttft | queue/prefill/redo/defrag):")
        for r in slow:
            lines.append(
                f"  {r.get('trace_id', '?'):<24} {r['ttft_ms']:8.1f}ms | "
                f"{r['queue_wait_ms']:.1f} / {r['prefill_ms']:.1f} / "
                f"{r['redo_wait_ms']:.1f} / {r['defrag_wait_ms']:.1f}"
                f"  (preempts {r.get('preemptions', 0)},"
                f" hops {len(json.loads(r['ctx'])['hops'])})")
    return "\n".join(lines)


# ------------------------------------------------------------------ selftest

def _selftest() -> int:
    assert "torch" not in sys.modules, \
        "obs_trace selftest must run torch-free (import-time hygiene)"
    assert os.path.exists(FIXTURE), f"missing fixture {FIXTURE}"

    trs, summ = analyze(FIXTURE)
    assert summ is not None and summ["requests"] >= 4, summ
    # every record reconciles: component sum == ttft (the recorder's
    # exactness contract, re-checked on the checked-in artifact)
    assert summ["recon_err_ms_max"] < 0.05, summ["recon_err_ms_max"]
    # the fixture is a preemption storm: redo must dominate the tail
    assert summ["tail"]["dominant"] == "preempt_redo", summ["tail"]
    # tail sampling kept every violator's spans
    for r in trs:
        if r.get("violated"):
            assert r.get("spans"), f"violator {r['rid']} lost its spans"
    out = render(summ, trs)
    for needle in ("== request traces ==", "tail attribution:",
                   "preempt_redo", "slowest requests"):
        assert needle in out, f"missing {needle!r} in:\n{out}"

    # --slo-ms re-judging: an absurdly high SLO clears all violations
    _, relaxed = analyze(FIXTURE, slo_ms=1e9)
    assert relaxed["violations"] == 0, relaxed["violations"]

    # round-trip: records -> chrome events -> a request track exists
    evs = reqtrace.chrome_events(trs)
    names = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert any(n.startswith("req ") for n in names), names
    kinds = {e["name"] for e in evs if e.get("ph") == "X"}
    assert {"queue", "prefill", "decode"} <= kinds, kinds
    assert "redo_prefill" in kinds, kinds

    # context wire round-trip (the router-propagation contract)
    ctx = reqtrace.TraceContext.from_wire(json.loads(trs[0]["ctx"]))
    assert ctx.to_wire() == json.loads(trs[0]["ctx"])
    assert ctx.hops and ctx.hops[0].startswith("engine"), ctx.hops

    # fleet reconciliation: one JSONL holding both the
    # router's fleettrace events and the replica's reqtrace events —
    # the decomposition identity and the engine-TTFT echo must both
    # reconcile exactly, and the section must render
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        fpath = os.path.join(d, "fleet.jsonl")
        with metrics.MetricsLogger(fpath, process_index=-2) as log:
            for i in range(4):
                retried = i == 3
                engine_ttft = 40.0 + i
                log.log_event(
                    "reqtrace", rid=i, trace_id=f"ptd-fleet-{i:08x}",
                    ttft_ms=engine_ttft, e2e_ms=engine_ttft + 20.0,
                    queue_wait_ms=5.0, prefill_ms=30.0,
                    redo_wait_ms=0.0, defrag_wait_ms=0.0,
                    other_wait_ms=engine_ttft - 35.0, tokens=8,
                    preemptions=0, violated=0, n_spans=4,
                    spans_dropped=0, sampled=1)
                log.log_event(
                    "fleettrace", rid=i, trace_id=f"ptd-fleet-{i:08x}",
                    replica=i % 2, attempts=2 if retried else 1,
                    hedged=0, router_wait_ms=1.25,
                    redispatch_ms=30.0 if retried else 0.0,
                    hedge_wait_ms=0.0, engine_ttft_ms=engine_ttft,
                    engine_e2e_ms=engine_ttft + 20.0,
                    router_ttft_ms=(1.25 + (30.0 if retried else 0.0)
                                    + engine_ttft),
                    router_e2e_ms=(1.25 + (30.0 if retried else 0.0)
                                   + engine_ttft + 20.0))
        ftrs, frec = analyze_fleet(fpath)
        assert frec is not None and frec["requests"] == 4, frec
        assert frec["retried"] == 1 and frec["hedged"] == 0, frec
        assert frec["decomp_err_ms_max"] < 1e-9, frec
        assert frec["engine_matched"] == 4, frec
        assert frec["engine_echo_err_ms_max"] < 1e-9, frec
        fout = render_fleet(frec)
        for needle in ("== fleet routing ==", "requests 4  retried 1",
                       "decomposition err max 0.0000ms",
                       "engine echo: 4 request(s) matched"):
            assert needle in fout, f"missing {needle!r} in:\n{fout}"
        # a routerless JSONL keeps the section (and --json key) out
        _t, none_rec = analyze_fleet(FIXTURE)
        assert none_rec is None, none_rec
        assert render_fleet(None) == ""

    assert "torch" not in sys.modules
    print("obs_trace selftest: OK")
    return 0


# ---------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-request serving-trace attribution")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="metrics JSONL holding reqtrace events")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable attribution summary")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="re-judge SLO violations against this TTFT target")
    ap.add_argument("--perfetto", default=None, metavar="OUT",
                    help="write per-request tracks as a Chrome-trace JSON")
    ap.add_argument("--selftest", action="store_true",
                    help="fixture round-trip + torch-free assertion")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()
    if not args.metrics_jsonl:
        ap.error("--metrics-jsonl is required (or --selftest)")
    trs, summ = analyze(args.metrics_jsonl, slo_ms=args.slo_ms)
    _ftrs, frec = analyze_fleet(args.metrics_jsonl)
    if args.perfetto:
        trace = {"traceEvents": reqtrace.chrome_events(trs),
                 "displayTimeUnit": "ms"}
        with open(args.perfetto, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.perfetto} "
              f"({len(trace['traceEvents'])} events)")
    if args.as_json:
        out = dict(summ) if summ else {}
        if frec is not None:
            out["fleet"] = frec
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(render(summ, trs, slo_ms=args.slo_ms))
        if frec is not None:
            print(render_fleet(frec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
