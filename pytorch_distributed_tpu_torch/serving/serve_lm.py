"""serve_lm — continuous-batching LM serving over the paged KV cache.

The port of ``scripts/serve_lm.py``: builds a seeded random-init
``TransformerLM`` parameter set (or reads one with ``--checkpoint``: an
``lm_pretrain`` checkpoint of either package, or a bare params tree in the
same msgpack format), a ``ServingEngine`` with a paged KV pool
and its decode step captured once as a CUDA graph, and drives a seeded
synthetic load trace (serving/loadgen.py) through it, writing the serving
SLO fields (TTFT / inter-token-latency percentiles, queue depth, KV
occupancy, preemptions, tokens/s) into a MetricsLogger JSONL and printing
the run summary as JSON.  The flags are the JAX script's plus ``--device``
(default ``cuda``; ``cpu`` runs the same step eagerly).

    python -m pytorch_distributed_tpu_torch.serving.serve_lm --device cpu --requests 8
    python -m pytorch_distributed_tpu_torch.serving.serve_lm --mode static ...

``--quant int8`` serves the int8 weight-only model (quantized after
``--checkpoint``, as the JAX script does); ``--gamma G`` decodes greedily
by speculation with a seeded random draft of ``--draft-d-model`` and
``--draft-layers``, one captured round per iteration.

``--slo-ttft-ms`` / ``--slo-kv-pct`` arm live ``ttft_p99`` /
``kv_occupancy`` alert rules (obs/alerts.py) over the run's own stream;
breaches are booked as ``alert`` ft_events in the JSONL.  ``--req-trace``
arms the per-request span recorder (obs/reqtrace.py): every request's
TTFT/e2e decomposes into queue-wait / prefill / preempt-redo / defrag
components, booked as ``reqtrace`` ft_events and read by
``tools/obs_trace.py``; ``--trace-sample`` is the span retention rate of
requests inside the SLO.  The recapture watchdog (obs/watchdog.py) watches
the decode graph's capture unless ``--no-watchdog``.

    python -m pytorch_distributed_tpu_torch.serving.serve_lm --device cpu \
        --req-trace --trace-sample 1.0 --slo-ttft-ms 500 --metrics-jsonl /tmp/serve.jsonl

Exit status 0 iff every request completed.
"""

from __future__ import annotations

import argparse
import json
import sys

from pytorch_distributed_tpu_torch.models.quant import quantize_state_dict
from pytorch_distributed_tpu_torch.obs.alerts import AlertEngine, Rule
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_tpu_torch.obs.reqtrace import ReqTracer
from pytorch_distributed_tpu_torch.obs.watchdog import RecompileWatchdog
from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
from pytorch_distributed_tpu_torch.serving.loadgen import LoadConfig, generate_load
from pytorch_distributed_tpu_torch.train.checkpoint import read_payload
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serve_lm",
        description="continuous-batching LM serving with a paged KV cache")
    m = ap.add_argument_group("model")
    m.add_argument("--vocab-size", type=int, default=64)
    m.add_argument("--d-model", type=int, default=32)
    m.add_argument("--n-heads", type=int, default=4)
    m.add_argument("--n-layers", type=int, default=2)
    m.add_argument("--quant", choices=("", "int8"), default="",
                   help="int8 = weight-only quantized serving "
                        "(models/quant.py)")
    m.add_argument("--checkpoint", default=None,
                   help="serve real weights from an LM msgpack (an lm_pretrain "
                        "checkpoint or a bare params tree; vocab/d_model/"
                        "n_layers are read from it, --n-heads must match)")
    m.add_argument("--gamma", type=int, default=0,
                   help="speculative draft length (0 = off; greedy only)")
    m.add_argument("--draft-d-model", type=int, default=16)
    m.add_argument("--draft-layers", type=int, default=1)

    e = ap.add_argument_group("engine")
    e.add_argument("--max-batch", type=int, default=4,
                   help="decode slot count (the static [B] batch)")
    e.add_argument("--kv-blocks", type=int, default=64,
                   help="paged KV pool size in blocks (block 0 reserved)")
    e.add_argument("--block-size", type=int, default=16,
                   help="tokens per KV block")
    e.add_argument("--blocks-per-seq", type=int, default=8,
                   help="block-table width = per-sequence token cap / "
                        "block size")
    e.add_argument("--chunk-size", type=int, default=8,
                   help="chunked-prefill chunk length")
    e.add_argument("--max-new-tokens", type=int, default=16,
                   help="cap on generated tokens per request")
    e.add_argument("--mode", choices=("continuous", "static"),
                   default="continuous",
                   help="static = naive wave batching (the A/B baseline)")
    e.add_argument("--policy", choices=("fcfs", "priority"),
                   default="fcfs")
    e.add_argument("--defrag-threshold-pct", type=float, default=50.0)
    e.add_argument("--temperature", type=float, default=0.0)
    e.add_argument("--top-k", type=int, default=0)
    e.add_argument("--top-p", type=float, default=1.0)
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    l = ap.add_argument_group("load")
    l.add_argument("--requests", type=int, default=32)
    l.add_argument("--rate-rps", type=float, default=50.0)
    l.add_argument("--profile", choices=("mixed", "uniform"),
                   default="mixed")
    l.add_argument("--seed", type=int, default=0)

    o = ap.add_argument_group("observability")
    o.add_argument("--metrics-jsonl", default=None,
                   help="serving SLO metrics JSONL, one record per step")
    o.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="arm a live ttft_p99 alert rule at this ceiling")
    o.add_argument("--slo-kv-pct", type=float, default=None,
                   help="arm a live kv_occupancy alert rule at this pct")
    o.add_argument("--req-trace", action="store_true", dest="req_trace",
                   help="per-request span tracing (obs/reqtrace.py): "
                        "TTFT/e2e critical-path attribution booked as "
                        "reqtrace ft_events; analyze with tools/obs_trace.py")
    o.add_argument("--trace-sample", type=float, default=0.05,
                   dest="trace_sample",
                   help="span retention rate for non-violating requests "
                        "(SLO violators always keep their spans)")
    o.add_argument("--no-watchdog", action="store_true",
                   help="disable the recapture watchdog around the decode "
                        "graph's capture")
    o.add_argument("--summary-json", default=None,
                   help="write the run summary dict to this path")
    return ap


def load_checkpoint_params(path: str, device="cuda"):
    """Read an LM msgpack (``payload["state"]["params"]`` of a checkpoint,
    or a bare params tree) and return ``(state_dict on device, vocab_size,
    d_model, n_layers)`` with the dims inferred from the tree itself
    (n_heads never shapes it)."""
    try:
        payload = read_payload(path)
    except NotImplementedError as e:  # an orbax checkpoint directory
        raise SystemExit(str(e)) from e
    state = payload.get("state", payload)
    params = state.get("params", state)
    if "embed" not in params:
        raise SystemExit(
            f"--checkpoint {path}: not an LM param tree (missing 'embed');"
            " convert with scripts/import_torch_checkpoint.py")
    vocab, d_model = params["embed"]["embedding"].shape
    n_layers = sum(1 for k in params if k.startswith("block_"))
    return (lm_state_dict_from_jax(params, device=resolve_device(device)), int(vocab),
            int(d_model), n_layers)


def serve(args, load=None):
    """Build the engine ``args`` describe, drive its seeded load (or
    ``load``, a list of ``(arrival_s, Request)``) to the end and return
    ``(summary, engine)``; the engine keeps its watchdog
    (``engine.watchdog``) and tracer (``engine.trace``)."""
    if args.checkpoint:
        (params, args.vocab_size, args.d_model,
         args.n_layers) = load_checkpoint_params(args.checkpoint, args.device)
    else:
        params = init_lm_params(args.vocab_size, args.d_model, args.n_heads,
                                args.n_layers, seed=args.seed, device=args.device)
    if args.quant == "int8":
        params = quantize_state_dict(params, device=resolve_device(args.device))
    draft = None
    if args.gamma > 0:
        draft = init_lm_params(args.vocab_size, args.draft_d_model, args.n_heads,
                               args.draft_layers, seed=args.seed + 1, device=args.device)

    obs = MetricsLogger(args.metrics_jsonl, flush_every=1)
    rules = []
    if args.slo_ttft_ms is not None:
        rules.append(Rule("ttft_p99", "ttft_p99", "page",
                          {"max_ms": float(args.slo_ttft_ms)}))
    if args.slo_kv_pct is not None:
        rules.append(Rule("kv_occupancy", "kv_occupancy", "warn",
                          {"max_pct": float(args.slo_kv_pct)}))
    if rules:
        alert_engine = AlertEngine(rules, emit=lambda **f: obs.log_event("alert", **f))
        obs.register(alert_engine.observe)

    wd = None
    if not args.no_watchdog:
        wd = RecompileWatchdog(obs=obs)
        wd.install()

    tracer = None
    if args.req_trace:
        tracer = ReqTracer(slo_ms=args.slo_ttft_ms, sample=args.trace_sample)

    try:
        eng = ServingEngine(
            params, vocab_size=args.vocab_size, d_model=args.d_model,
            n_heads=args.n_heads, n_layers=args.n_layers,
            max_batch=args.max_batch, kv_blocks=args.kv_blocks,
            block_size=args.block_size, blocks_per_seq=args.blocks_per_seq,
            chunk_size=args.chunk_size, max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            quant=args.quant, gamma=args.gamma, draft_params=draft,
            policy=args.policy, mode=args.mode,
            defrag_threshold_pct=args.defrag_threshold_pct,
            obs=obs, watchdog=wd, trace=tracer, seed=args.seed, device=args.device)
        del params, draft

        if load is None:
            load = generate_load(LoadConfig(
                n_requests=args.requests, rate_rps=args.rate_rps,
                profile=args.profile, vocab_size=args.vocab_size, seed=args.seed))
        for _, req in load:
            req.max_new_tokens = min(req.max_new_tokens, args.max_new_tokens)
        summary = eng.run(load)
    finally:
        if wd is not None:
            wd.uninstall()
        obs.close()

    summary["recompile_anomalies"] = len(wd.anomalies) if wd else None
    if tracer is not None:
        summary["traces_completed"] = tracer.completed
        summary["trace_violations"] = tracer.violations
        summary["trace_spans_dropped"] = tracer.spans_dropped
    summary["decode_graph_captures"] = eng.graph_captures
    summary["decode_graph_replays"] = eng.graph_replays
    summary["decode_iterations"] = eng.decode_iterations
    return summary, eng


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    summary, _ = serve(args)
    print(json.dumps(summary, indent=2, sort_keys=True))
    if args.summary_json:
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
    return 0 if summary["completed"] == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
