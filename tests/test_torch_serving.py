"""The port's paged serving engine (``pytorch_distributed_tpu_torch/serving``)
against the JAX package's, on the CPU at the JAX serving tests' size.

The same numpy-seeded inputs, weights (carried over by
``lm_state_dict_from_jax``) and load traces go through both packages:

- the host halves (``BlockPool``, ``Scheduler``, ``generate_load``) must
  make identical decisions;
- the device helpers and ``PagedTransformerLM`` must agree to the f32
  LM-forward tolerance, 2e-4;
- the engines must emit the same tokens for every request, up to the first
  position where the JAX side's top-2 logit gap is under 2e-4 (the logit
  tolerance: a closer pair may legitimately flip), and report identical
  scheduling counters.  Requests stop only at ``max_new_tokens``, so the
  schedule does not depend on token values and the counters must match
  exactly.

The int8 engine and the speculative one (gamma 3, a 16-wide one-layer
draft) are held to the same rules, and the speculative engine's tokens
must also equal the port's own engine without a draft: its rounds accept
against the target's greedy argmax.

Every engine runs on a fake clock, and every JAX engine uses one shape
configuration, so its jitted steps compile once per process (once more
for the int8 model and the speculative round).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import quant as jq
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.serving import kvpool as jkv
from pytorch_distributed_tpu.serving import loadgen as jload
from pytorch_distributed_tpu.serving import scheduler as jsched
from pytorch_distributed_tpu.serving.engine import ServingEngine as JaxEngine
from pytorch_distributed_tpu.serving.model import PagedTransformerLM as JaxPagedLM
from pytorch_distributed_tpu_torch.models.generate import filter_logits, greedy_generate
from pytorch_distributed_tpu_torch.models.quant import quantize_state_dict
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM, rope
from pytorch_distributed_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_tpu_torch.serving import kvpool, loadgen, scheduler
from pytorch_distributed_tpu_torch.serving.engine import ServingEngine, init_lm_params
from pytorch_distributed_tpu_torch.serving.model import PagedTransformerLM, rope_at
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)
BS = 8
# One engine shape for every JAX engine here: 12 usable blocks of 8 tokens
# for 4 slots of up to 64 tokens, small enough that the burst of seed 4
# preempts in both modes.
ENG = dict(max_batch=4, kv_blocks=13, block_size=BS, blocks_per_seq=8,
           chunk_size=8, max_new_tokens=64)
LOGIT_TOL = 2e-4   # the port's f32 LM-forward tolerance (PERF.md §2)
SEQ_PAD = 64       # teacher-forced sequences padded to one length: one compile


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


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's state dict of the same numbers)."""
    params = jax.jit(JaxLM(**CFG).init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4), jnp.int32))["params"]
    return params, lm_state_dict_from_jax(jax.device_get(params))


def _fake_clock():
    t = [0.0]
    return (lambda: t[0]), (lambda s: t.__setitem__(0, t[0] + max(s, 1e-3)))


def _engine(cls, params, **kw):
    time_fn, sleep_fn = _fake_clock()
    args = dict(ENG, time_fn=time_fn, sleep_fn=sleep_fn, seed=0, **CFG)
    args.update(kw)
    if cls is ServingEngine:
        args.setdefault("device", "cpu")
    return cls(params, **args)


def _load(mod, seed=4, n=12):
    """A burst of a mixed trace (prompts 4-12, 80% of outputs 2-8 tokens,
    20% 32-48) from either package's loadgen, every request arriving at 0
    so that a queue forms on the fake clock."""
    return [(0.0, req) for _, req in mod.generate_load(mod.LoadConfig(
        n_requests=n, profile="mixed", vocab_size=CFG["vocab_size"], seed=seed))]


def _tokens(eng):
    return {r.rid: list(r.generated) for r in eng.finished}


def _top2_gaps(logits):
    """Top-1 minus top-2 logit at each position of ``[..., V]``."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.fixture(scope="module")
def jax_forward(weights):
    params = weights[0]
    return jax.jit(lambda toks: JaxLM(**CFG).apply({"params": params}, toks))


def _jax_gaps(jax_forward, prompt, toks):
    """Gap of the teacher-forced JAX logits that chose each of ``toks``."""
    seq = np.zeros((1, SEQ_PAD), np.int32)
    seq[0, :len(prompt) + len(toks)] = list(prompt) + list(toks)
    logits = np.asarray(jax_forward(jnp.asarray(seq)))[0]
    return _top2_gaps(logits[len(prompt) - 1:len(prompt) - 1 + len(toks)])


def _compare_under_margin(got, want, gaps):
    """Assert ``got == want`` per rid up to each rid's first position with
    a gap under LOGIT_TOL; returns (tokens compared, tokens cut)."""
    compared = cut = 0
    assert set(got) == set(want)
    for rid, w in want.items():
        n = next((j for j, g in enumerate(gaps[rid]) if g < LOGIT_TOL), len(w))
        assert len(got[rid]) == len(w), rid
        assert got[rid][:n] == w[:n], (rid, n, got[rid], w)
        compared += n
        cut += len(w) - n
    return compared, cut


# ------------------------------------------------------------- host halves

def _drive_pool(mod, seed):
    """A seeded run of ensure / free / defrag / table calls; returns every
    observable result."""
    rng = np.random.default_rng(seed)
    pool = mod.BlockPool(n_blocks=13, block_size=4, blocks_per_seq=5)
    seen = []
    for _ in range(200):
        sid = int(rng.integers(0, 6))
        op = rng.random()
        if op < 0.55:
            seen.append(("ensure", pool.ensure(sid, int(rng.integers(1, 21)))))
        elif op < 0.8:
            seen.append(("free", pool.free(sid)))
        elif op < 0.9:
            seen.append(("defrag", pool.defrag().tolist()))
        else:
            sids = [int(s) if s < 6 else None for s in rng.integers(0, 8, size=3)]
            seen.append(("table", pool.table(sids).tolist()))
        seen.append((pool.free_blocks, pool.used_blocks, pool.occupancy_pct(),
                     pool.fragmentation_pct(), pool.alloc_failures, pool.defrags,
                     [pool.blocks_of(s) for s in range(6)]))
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_blockpool_matches_jax(seed):
    want, got = _drive_pool(jkv, seed), _drive_pool(kvpool, seed)
    assert got == want
    kinds = {s[0] for s in want if isinstance(s[0], str)}
    assert kinds == {"ensure", "free", "defrag", "table"}
    assert any(s[0] == "defrag" and s[1] != list(range(13)) for s in want)


def _budget(n):
    """An admission probe that accepts the first ``n`` requests it sees."""
    left = [n]

    def can_admit(req):
        left[0] -= 1
        return left[0] >= 0

    return can_admit


def _drive_scheduler(mod, policy, seed):
    rng = np.random.default_rng(seed)
    s = mod.Scheduler(max_batch=3, policy=policy)
    seen, rid = [], 0
    for _ in range(150):
        op = rng.random()
        if op < 0.35:
            s.submit(mod.Request(rid=rid, prompt=[0], max_new_tokens=4,
                                 priority=int(rng.integers(0, 3))), now=float(rid))
            rid += 1
        elif op < 0.6:
            placed = s.admit(_budget(int(rng.integers(0, 4))))
            seen.append(("admit", [(i, r.rid) for i, r in placed]))
        elif op < 0.75:
            active = [i for i, _ in s.active]
            protect = tuple(active[:int(rng.integers(0, 2))])
            seen.append(("victim", s.pick_victim(protect=protect)))
        elif op < 0.87 and s.active:
            slot = s.active[int(rng.integers(0, len(s.active)))][0]
            seen.append(("preempt", s.preempt(slot).rid))
        elif s.active:
            slot = s.active[int(rng.integers(0, len(s.active)))][0]
            seen.append(("finish", s.finish(slot, now=1.0).rid))
        seen.append(([None if r is None else r.rid for r in s.slots], s.queue_depth,
                     s.preemptions, s.admitted, s.completed))
    return seen


@pytest.mark.parametrize("policy", ["fcfs", "priority"])
def test_scheduler_matches_jax(policy):
    want = _drive_scheduler(jsched, policy, 3)
    assert _drive_scheduler(scheduler, policy, 3) == want
    kinds = {s[0] for s in want if isinstance(s[0], str)}
    assert kinds == {"admit", "victim", "preempt", "finish"}


@pytest.mark.parametrize("profile", ["mixed", "uniform"])
def test_generate_load_matches_jax(profile):
    def trace(mod):
        return [(t, r.rid, list(r.prompt), r.max_new_tokens, r.priority)
                for t, r in mod.generate_load(mod.LoadConfig(n_requests=24, profile=profile,
                                                             seed=11))]

    assert trace(loadgen) == trace(jload)
    assert isinstance(loadgen.generate_load(loadgen.LoadConfig(n_requests=1))[0][1],
                      scheduler.Request)


# ---------------------------------------------------------- device helpers

def test_device_helpers_match_jax():
    """lookup_blocks (null routing past the table), paged_scatter in place,
    paged_gather and the in-place apply_permutation against the JAX
    functions on the same seeded data."""
    rng = np.random.default_rng(0)
    NB, W, H, D = 9, 3, 2, 4
    table = np.array([[3, 5, 0], [7, 0, 0]], np.int32)
    pos = np.array([[0, 5, 11, 12, 30], [2, 9, 15, 3, 1]], np.int32)
    want_blk = np.asarray(jkv.lookup_blocks(jnp.asarray(table), jnp.asarray(pos), 4))
    got_blk = kvpool.lookup_blocks(torch.from_numpy(table).long(), torch.from_numpy(pos).long(), 4)
    np.testing.assert_array_equal(got_blk.numpy(), want_blk)
    assert got_blk[0, 3] == 0 and got_blk[0, 4] == 0   # past the 3-block window
    assert got_blk[1, 1] == 0                          # unset table entry

    pool = rng.standard_normal((NB, 4, H, D)).astype(np.float32)
    val = rng.standard_normal((2, 5, H, D)).astype(np.float32)
    off = pos % 4
    want = np.asarray(jkv.paged_scatter(jnp.asarray(pool), jnp.asarray(want_blk),
                                        jnp.asarray(off), jnp.asarray(val)))
    tpool = torch.from_numpy(pool.copy())
    out = kvpool.paged_scatter(tpool, got_blk, torch.from_numpy(off).long(),
                               torch.from_numpy(val))
    assert out is tpool
    # block 0 takes duplicate writes (garbage by contract): compare the rest
    np.testing.assert_array_equal(tpool.numpy()[1:], want[1:])
    assert np.isfinite(tpool.numpy()[0]).all()

    want_g = np.asarray(jkv.paged_gather(jnp.asarray(want), jnp.asarray(table)))
    got_g = kvpool.paged_gather(torch.tensor(want), torch.from_numpy(table).long())
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    assert got_g.shape == (2, W * 4, H, D)

    full = rng.standard_normal((2, NB, 4, H, D)).astype(np.float32)
    perm = rng.permutation(NB).astype(np.int32)
    want_p = np.asarray(jkv.apply_permutation(jnp.asarray(full), jnp.asarray(perm)))
    tfull = torch.from_numpy(full.copy())
    ptr = tfull.data_ptr()
    kvpool.apply_permutation(tfull, torch.from_numpy(perm).long())
    assert tfull.data_ptr() == ptr
    np.testing.assert_array_equal(tfull.numpy(), want_p)

    pk, pv = kvpool.init_pools(2, NB, 4, H, D, device="cpu")
    assert pk.shape == (2, NB, 4, H, D) and pk.dtype == torch.float32
    assert not pk.any() and not pv.any() and pk.data_ptr() != pv.data_ptr()


def test_defrag_preserves_gathered_kv_in_place():
    """Free a middle sequence, defrag, permute the pool in place: gathers
    through the rewritten tables are bit-identical, as in the JAX test."""
    pool = kvpool.BlockPool(n_blocks=8, block_size=4, blocks_per_seq=3)
    for sid in (0, 1, 2):
        assert pool.ensure(sid, 8)
    pool.free(1)
    assert pool.fragmentation_pct() > 0.0
    pk, _ = kvpool.init_pools(1, 8, 4, 2, 4, device="cpu")
    pk += torch.arange(8, dtype=torch.float32)[None, :, None, None, None]
    before = {sid: kvpool.paged_gather(pk[0], torch.from_numpy(pool.table([sid])).long())
              for sid in (0, 2)}
    perm = pool.defrag()
    assert pool.defrags == 1 and pool.fragmentation_pct() == 0.0
    view = pk[0]
    kvpool.apply_permutation(pk, torch.from_numpy(perm).long())
    for sid in (0, 2):
        after = kvpool.paged_gather(view, torch.from_numpy(pool.table([sid])).long())
        assert torch.equal(after, before[sid])


# ------------------------------------------------------------------- model

def test_rope_at_matches_rope_at_equal_positions():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, 3, 8))
                         .astype(np.float32))
    for off in (0, 7, 300):
        pos = torch.arange(off, off + 5).expand(2, 5)
        assert torch.equal(rope_at(x, pos), rope(x, offset=off))


def test_paged_model_matches_jax(weights):
    """One prefill chunk, then one decode step of two slots at different
    offsets: logits and the written pools agree with the JAX model to
    2e-4.  The JAX params load with strict=True."""
    params, sd = weights
    NB, W = 9, 4
    jm = jax.jit(JaxPagedLM(block_size=BS, **CFG).apply)
    model = PagedTransformerLM(block_size=BS, device="cpu", **CFG)
    model.load_state_dict(sd, strict=True)
    jpk, jpv = jkv.init_pools(CFG["n_layers"], NB, BS, CFG["n_heads"], 8)
    pk, pv = kvpool.init_pools(CFG["n_layers"], NB, BS, CFG["n_heads"], 8, device="cpu")
    rng = np.random.default_rng(2)
    table = np.array([[3, 5, 1, 0], [2, 7, 0, 0]], np.int32)

    # prefill rid 0: 8 tokens, the last 3 lanes padding past its window
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = rng.integers(0, CFG["vocab_size"], 5)
    pos = np.arange(8, dtype=np.int32)[None]
    jl, jpk, jpv = jm({"params": params}, jnp.asarray(chunk), jpk, jpv,
                            jnp.asarray(table[:1]), jnp.asarray(pos))
    with torch.no_grad():
        tl = model(torch.from_numpy(chunk).long(), pk, pv, torch.from_numpy(table[:1]).long(),
                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)

    # decode: slot 0 at offset 5, slot 1 (nothing written yet) at offset 0
    toks = rng.integers(0, CFG["vocab_size"], (2, 1)).astype(np.int32)
    pos = np.array([[5], [0]], np.int32)
    jl, jpk, jpv = jm({"params": params}, jnp.asarray(toks), jpk, jpv,
                            jnp.asarray(table), jnp.asarray(pos))
    with torch.no_grad():
        tl = model(torch.from_numpy(toks).long(), pk, pv, torch.from_numpy(table).long(),
                   torch.from_numpy(pos).long())
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for got, want in ((pk, jpk), (pv, jpv)):
        np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(want)[:, 1:],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ------------------------------------------------------------------ engine

COUNTERS = ("completed", "tokens", "steps", "preemptions", "defrags", "alloc_failures")


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_engine_matches_jax_engine(weights, jax_forward, mode):
    """The same mixed trace on a pool small enough to preempt: the same
    tokens for every rid (under the margin rule) and the same counters."""
    params, sd = weights
    jeng = _engine(JaxEngine, params, mode=mode)
    want_summary = jeng.run(_load(jload))
    eng = _engine(ServingEngine, sd, mode=mode)
    summary = eng.run(_load(loadgen))
    assert {k: summary[k] for k in COUNTERS} == {k: want_summary[k] for k in COUNTERS}
    assert summary["completed"] == 12 and summary["preemptions"] > 0
    want = _tokens(jeng)
    prompts = {r.rid: r.prompt for _, r in _load(loadgen)}
    gaps = {rid: _jax_gaps(jax_forward, prompts[rid], toks) for rid, toks in want.items()}
    compared, cut = _compare_under_margin(_tokens(eng), want, gaps)
    print(f"{mode}: {compared} tokens compared, {cut} cut by the margin rule")
    assert compared >= 0.9 * sum(len(t) for t in want.values())
    assert eng.decode_iterations > 0
    assert eng.graph_captures == eng.graph_replays == 0   # eager on the CPU


def test_engine_matches_dense_greedy_generate(weights):
    """Mixed-length trace through admission, chunked prefill and paged
    decode against the port's dense KV-cache greedy path, one request at a
    time (margin rule on the dense side's teacher-forced logits)."""
    _, sd = weights
    load = _load(loadgen, seed=3, n=10)
    eng = _engine(ServingEngine, sd)
    assert eng.run(copy.deepcopy(load))["completed"] == 10
    dense = TransformerLM(**CFG, device="cpu")
    dense.load_state_dict(sd)
    want, gaps = {}, {}
    with torch.no_grad():
        for _, req in load:
            prompt = torch.tensor([list(req.prompt)])
            toks = greedy_generate(dense, prompt, req.max_new_tokens, flash_prefill=False)
            want[req.rid] = toks[0].tolist()
            logits = dense(torch.cat([prompt, toks.long()], dim=1))[0]
            gaps[req.rid] = _top2_gaps(logits[len(req.prompt) - 1:-1].numpy())
    compared, cut = _compare_under_margin(_tokens(eng), want, gaps)
    print(f"{compared} tokens compared, {cut} cut by the margin rule")
    assert compared >= 0.9 * sum(len(t) for t in want.values())


def test_sampled_tokens_lie_in_the_kept_set(weights):
    """temperature > 0 samples outside the step from its f32 logits: every
    token (the prefill's first included) lies in ``filter_logits``'s kept
    set of the teacher-forced logits, and one seed replays the draws."""
    _, sd = weights
    kw = dict(temperature=0.9, top_k=5, top_p=0.8)
    eng = _engine(ServingEngine, sd, **kw)
    eng.run(_load(loadgen, seed=4, n=6))
    again = _engine(ServingEngine, sd, **kw)
    again.run(_load(loadgen, seed=4, n=6))
    assert _tokens(again) == _tokens(eng)
    dense = TransformerLM(**CFG, device="cpu")
    dense.load_state_dict(sd)
    prompts = {r.rid: list(r.prompt) for _, r in _load(loadgen, seed=4, n=6)}
    n_tok = 0
    with torch.no_grad():
        for rid, toks in _tokens(eng).items():
            logits = dense(torch.tensor([prompts[rid] + toks]))[0]
            kept = filter_logits(logits[len(prompts[rid]) - 1:-1], kw["temperature"],
                                 kw["top_k"], kw["top_p"])
            picked = kept[torch.arange(len(toks)), torch.tensor(toks)]
            assert torch.isfinite(picked).all(), rid
            n_tok += len(toks)
    # every request ran to its cap (the summary also counts tokens a
    # preemption discarded)
    assert n_tok == sum(r.max_new_tokens for r in eng.finished) > 0
    assert len({t for toks in _tokens(eng).values() for t in toks}) > 1


def test_stream_callback_ordering(weights):
    _, sd = weights
    events = []
    eng = _engine(ServingEngine, sd, stream=lambda rid, tok, kind: events.append((rid, tok, kind)))
    eng.run(_load(loadgen, seed=7, n=5))
    for r in eng.finished:
        mine = [(t, k) for rid, t, k in events if rid == r.rid]
        # a preempted request restarts: its last "first" opens the final run
        last = max(i for i, (_, k) in enumerate(mine) if k == "first")
        assert [k for _, k in mine[last:]] == ["first"] + ["token"] * (len(mine) - last - 1)
        assert [t for t, _ in mine[last:]] == r.generated


def test_soak_never_rebinds_what_the_decode_graph_holds(weights):
    """The counterpart of the JAX zero-recompile soak: through admissions,
    finishes, preemptions and defrags, the pools and the decode step's
    input buffers keep their storage (the CUDA graph holds their
    addresses), and the step runs once per decode iteration."""
    eng = _engine(ServingEngine, weights[1], defrag_threshold_pct=10.0)
    held = [t.data_ptr() for t in (eng.pk, eng.pv, eng._d_tokens, eng._d_offsets,
                                   eng._d_table)]
    calls = []
    step = eng._run_decode_step
    eng._run_decode_step = lambda: calls.append(1) or step()
    summary = eng.run(_load(loadgen, seed=8, n=24))
    assert summary["completed"] == 24
    assert summary["defrags"] >= 1 and summary["preemptions"] >= 1
    assert [t.data_ptr() for t in (eng.pk, eng.pv, eng._d_tokens, eng._d_offsets,
                                   eng._d_table)] == held
    assert len(calls) == eng.decode_iterations > 0


def test_engine_logs_slo_fields_and_events(weights):
    """The preempting burst with a MetricsLogger: every step record carries
    the SLO fields ``_log_metrics`` names, and each preemption and defrag
    is booked as an event."""
    records = []
    obs = MetricsLogger(None, flush_every=1)
    obs.register(records.append)
    eng = _engine(ServingEngine, weights[1], obs=obs)
    summary = eng.run(_load(loadgen))
    obs.close()
    steps = [r for r in records if "ft_event" not in r and r.get("serving")]
    assert steps
    for field in ("queue_depth", "active_seqs", "kv_occupancy_pct", "kv_frag_pct",
                  "preemptions", "requests_completed", "tokens_per_s", "ttft_p50_ms",
                  "ttft_p95_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p95_ms", "itl_p99_ms"):
        assert field in steps[-1], field
    events = [r["ft_event"] for r in records if "ft_event" in r]
    assert events.count("serve_preempt") == summary["preemptions"] > 0
    assert events.count("serve_defrag") == summary["defrags"] > 0


# ------------------------------------------- engine: int8 and speculation

def test_int8_engine_matches_jax_int8_engine(weights):
    """``quant="int8"`` as the JAX ``test_int8_serving_smoke`` runs it (4
    requests of up to 6 new tokens), on the shared engine shape: the same
    counters, and the tokens of the JAX int8 engine under the margin rule
    of the JAX int8 model's teacher-forced logits."""
    params = weights[0]
    qparams = jq.quantize_lm_params(params)
    load = _load(loadgen, seed=6, n=4)
    for _, req in load:
        req.max_new_tokens = min(req.max_new_tokens, 6)
    jload_ = _load(jload, seed=6, n=4)
    for _, req in jload_:
        req.max_new_tokens = min(req.max_new_tokens, 6)
    jeng = _engine(JaxEngine, qparams, quant="int8")
    want_summary = jeng.run(jload_)
    eng = _engine(ServingEngine, quantize_state_dict(weights[1]), quant="int8")
    summary = eng.run(load)
    assert {k: summary[k] for k in COUNTERS} == {k: want_summary[k] for k in COUNTERS}
    assert summary["completed"] == 4
    assert eng.model.blocks[0].fc1.w_q.dtype == torch.int8
    jfwd = jax.jit(lambda toks: JaxLM(**CFG, quant="int8").apply({"params": qparams}, toks))
    want = _tokens(jeng)
    prompts = {r.rid: r.prompt for _, r in load}
    gaps = {rid: _jax_gaps(jfwd, prompts[rid], toks) for rid, toks in want.items()}
    compared, _ = _compare_under_margin(_tokens(eng), want, gaps)
    assert compared >= 0.9 * sum(len(t) for t in want.values())
    for r in eng.finished:
        assert len(r.generated) == r.max_new_tokens


def test_speculative_engine_matches_jax_and_plain_engines(weights):
    """gamma=3 with a 16-wide one-layer draft, as the JAX
    ``test_speculative_decode_bit_exact`` runs it: the tokens of the port's
    engine without a draft, and the JAX speculative engine's tokens and
    counters; never more iterations than without the draft."""
    params, sd = weights
    jdraft = jax.tree_util.tree_map(np.asarray, jax.jit(JaxLM(
        vocab_size=CFG["vocab_size"], d_model=16, n_heads=CFG["n_heads"], n_layers=1).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"])
    draft = lm_state_dict_from_jax(jdraft)
    plain = _engine(ServingEngine, sd)
    plain.run(_load(loadgen, seed=5, n=6))
    jeng = _engine(JaxEngine, params, gamma=3, draft_params=jdraft)
    want_summary = jeng.run(_load(jload, seed=5, n=6))
    spec = _engine(ServingEngine, sd, gamma=3, draft_params=draft)
    summary = spec.run(_load(loadgen, seed=5, n=6))
    assert summary["completed"] == 6
    assert _tokens(spec) == _tokens(plain) == _tokens(jeng)
    assert {k: summary[k] for k in COUNTERS} == {k: want_summary[k] for k in COUNTERS}
    assert summary["steps"] <= plain.summary()["steps"]
    assert spec.draft is not None and spec.decode_iterations > 0


def test_speculative_engine_is_greedy_only_and_needs_a_draft(weights):
    with pytest.raises(ValueError, match="greedy-only"):
        _engine(ServingEngine, weights[1], gamma=2, temperature=0.5,
                draft_params=weights[1])
    with pytest.raises(ValueError, match="requires draft_params"):
        _engine(ServingEngine, weights[1], gamma=2)


def test_engine_runs_on_cuda_by_default_and_raises_without_a_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(ENG, **CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(weights[1], **args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(**CFG)


def test_init_lm_params_is_seeded_and_loads_both_models():
    a, b = init_lm_params(seed=5, device="cpu", **CFG), init_lm_params(seed=5, device="cpu", **CFG)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"],
                           init_lm_params(seed=6, device="cpu", **CFG)["embed.weight"])
    PagedTransformerLM(block_size=BS, device="cpu", **CFG).load_state_dict(a, strict=True)
    TransformerLM(**CFG, device="cpu").load_state_dict(a, strict=True)
