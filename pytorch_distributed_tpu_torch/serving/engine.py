"""Continuous-batching serving loop over the paged KV cache.

Port of ``pytorch_distributed_tpu/serving/engine.py``.  One decode step per
engine iteration, always at the full ``[max_batch]`` static shape:
sequences join and leave the batch by flipping slots and block-table rows,
never by changing tensor shapes.  Where the JAX engine compiles that step
once, this one captures it once per engine as a CUDA graph (the paged
forward, then the greedy argmax) and replays it every iteration: before
each replay the host fills the graph's static ``tokens``, ``offsets`` and
``table`` buffers with ``copy_``, and the pools are written in place, so
no address the graph holds ever changes.  The only host sync per decode
iteration is the one copy of the sampled tokens to the host.  On the CPU
the same step runs eagerly.

Prefill runs eagerly, one ``[1, chunk_size]`` chunk at a time.  Sampling
at ``temperature > 0`` happens outside the graph, from its f32 logits,
with a ``torch.Generator`` seeded from ``seed``.

The layers underneath compose as in the JAX engine: ``quant="int8"`` runs
the int8 weight-only paged model (``params`` from
``models/quant.py::quantize_state_dict``), and greedy speculative decoding
(``gamma > 0`` with ``draft_params``) replaces the decode step with one
round over the paged state: gamma+1 draft micro-steps (the last only
commits the final draft token's k/v), one target verification over
``[t_last, d_1..d_gamma]`` and the acceptance on the device, ``-1`` past
the accepted prefix and its correction.  The round is captured as the
graph in place of the decode step, so a round is still one replay and one
host sync.  Outputs equal the target's own greedy stream, whatever the
draft.

Three hooks sit where the JAX engine has them, each guarded by ``is not
None`` so the untraced path pays one branch: ``trace``
(``obs/reqtrace.py::ReqTracer``: submit, admit, prefill chunk marks and
their redo after a preemption, decode, emit, preempt, defrag, completion,
its gauges in each step record and its records drained to ``reqtrace``
events), ``watchdog`` (``obs/watchdog.py``: the decode graph's capture,
the port's compile event, runs inside ``watch("serve_decode")``; replays
and the eager prefill capture nothing, so they are not watched) and
``chaos`` (``ft/chaos.py``: ``on_step(engine, step)`` at the top of every
step).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import filter_logits
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.obs.metrics import _percentile
from pytorch_distributed_tpu_torch.serving.kvpool import (
    BlockPool,
    apply_permutation,
    init_pools,
)
from pytorch_distributed_tpu_torch.serving.model import PagedTransformerLM
from pytorch_distributed_tpu_torch.serving.scheduler import Request, Scheduler
from pytorch_distributed_tpu_torch.utils.device import resolve_device

MODES = ("continuous", "static")


def _pct_ms(samples, q: float) -> Optional[float]:
    """Nearest-rank percentile of a seconds-sample deque, in ms."""
    if not samples:
        return None
    return _percentile(sorted(samples), q) * 1e3


class ServingEngine:
    """Continuous-batching engine: paged KV + scheduler + a graphed decode.

    ``params`` is a ``TransformerLM`` state dict (``init_lm_params``, or
    ``utils/convert.py::lm_state_dict_from_jax``; ``quantize_state_dict``'s
    under ``quant="int8"``); the engine runs it in f32 on ``device``
    (``cuda`` unless the caller passes ``cpu``).  ``draft_params``: the
    state dict of the speculative draft (its width and depth are read from
    it; it shares ``n_heads`` and the block tables), used when ``gamma > 0``.

    ``mode="static"`` is the naive wave-batching baseline: a new wave is
    admitted only once every slot has drained, so short sequences idle
    behind the longest one.  Each request stops at its own
    ``max_new_tokens`` (``serve_lm`` clamps them to its flag); the
    engine's ``max_new_tokens`` is accepted for the JAX engine's signature
    and, as there, not read.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], *, vocab_size: int,
                 d_model: int, n_heads: int, n_layers: int,
                 max_batch: int = 4, kv_blocks: int = 64,
                 block_size: int = 16, blocks_per_seq: int = 8,
                 chunk_size: int = 8, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, quant: str = "",
                 gamma: int = 0, draft_params=None,
                 policy: str = "fcfs", mode: str = "continuous",
                 defrag_threshold_pct: float = 50.0,
                 obs=None, watchdog=None, chaos=None, trace=None,
                 stream: Optional[Callable[[int, int, str], None]] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 seed: int = 0, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected {MODES}")
        if gamma > 0 and temperature > 0:
            raise ValueError("speculative serving is greedy-only: "
                             "gamma > 0 requires temperature <= 0")
        if gamma > 0 and draft_params is None:
            raise ValueError("gamma > 0 requires draft_params")
        self.device = resolve_device(device)
        self.mode = mode
        self.gamma = int(gamma)
        self.max_batch = int(max_batch)
        self.chunk_size = int(chunk_size)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.defrag_threshold_pct = float(defrag_threshold_pct)
        self.obs = obs
        self.watchdog = watchdog
        self.chaos = chaos
        # per-request tracer: every hook below is guarded by ``is not
        # None``; traced hooks are tuple appends and clock reads.
        self.trace = trace
        self._step = 0
        self.stream = stream
        self._time_fn = time_fn
        self._sleep_fn = sleep_fn
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.model = PagedTransformerLM(
            vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
            n_layers=n_layers, block_size=block_size, quant=quant, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.requires_grad_(False)
        self.pool = BlockPool(kv_blocks, block_size, blocks_per_seq)
        self.pk, self.pv = init_pools(n_layers, kv_blocks, block_size, n_heads,
                                      d_model // n_heads, device=self.device)
        self.sched = Scheduler(max_batch, policy=policy)
        self.draft = None
        if self.gamma > 0:
            d_layers = len({k.split(".")[1] for k in draft_params if k.startswith("blocks.")})
            d_model_d = int(draft_params["embed.weight"].shape[1])
            self.draft = PagedTransformerLM(
                vocab_size=vocab_size, d_model=d_model_d, n_heads=n_heads,
                n_layers=d_layers, block_size=block_size, device=self.device)
            self.draft.load_state_dict(draft_params, strict=True)
            self.draft.requires_grad_(False)
            self.dpk, self.dpv = init_pools(d_layers, kv_blocks, block_size, n_heads,
                                            d_model_d // n_heads, device=self.device)

        # per-slot device-batch state (host mirrors)
        self._offsets = np.zeros(self.max_batch, np.int32)
        self._last = np.zeros(self.max_batch, np.int32)
        self._last_emit = [0.0] * self.max_batch

        # The decode step's static inputs: filled with copy_ before every
        # step, never rebound (the graph holds their addresses).
        self._d_tokens = torch.zeros(self.max_batch, dtype=torch.int64, device=self.device)
        self._d_offsets = torch.zeros_like(self._d_tokens)
        self._d_table = torch.zeros(self.max_batch, blocks_per_seq, dtype=torch.int64,
                                    device=self.device)
        self.graph_captures = 0
        self.graph_replays = 0
        self.decode_iterations = 0
        self._graph = None
        if self.device.type == "cuda":
            self._capture_decode()

        # SLO samples + counters
        self.ttft_samples: deque = deque(maxlen=512)
        self.itl_samples: deque = deque(maxlen=2048)
        self.total_tokens = 0
        self.finished: List[Request] = []
        self._t0: Optional[float] = None

    # ---------------------------------------------------------- decode step
    @torch.no_grad()
    def _decode_step(self):
        """tokens [B] fed at positions ``offsets`` -> (f32 logits [B, V],
        greedy next token [B]); with a draft, ``(None, the speculative
        round's [B, gamma+1] tokens)``.  Reads only the static input
        buffers."""
        if self.draft is not None:
            return None, self._spec_round()
        logits = self.model(self._d_tokens[:, None], self.pk, self.pv, self._d_table,
                            self._d_offsets[:, None])[:, -1, :]
        return logits, torch.argmax(logits, dim=-1)

    def _spec_round(self) -> torch.Tensor:
        """One greedy speculative round (the JAX ``_make_spec_round``):
        ``out [B, gamma+1]``, row b the committed tokens of slot b, the
        accepted draft tokens then the target's correction, -1 after."""
        gamma, table, offs = self.gamma, self._d_table, self._d_offsets
        cur = self._d_tokens
        toks = [cur]
        for i in range(gamma):
            logits = self.draft(cur[:, None], self.dpk, self.dpv, table, (offs + i)[:, None])
            cur = torch.argmax(logits[:, -1, :], dim=-1)
            toks.append(cur)
        # extra feed: writes KV(d_gamma); its output is discarded
        self.draft(cur[:, None], self.dpk, self.dpv, table, (offs + gamma)[:, None])
        ver = torch.stack(toks, dim=1)                          # [B, gamma+1]
        L = gamma + 1
        j = torch.arange(L, device=ver.device)[None, :]
        logits = self.model(ver, self.pk, self.pv, table, offs[:, None] + j)
        g = torch.argmax(logits, dim=-1)                        # target greedy
        p = ver[:, 1:]                                          # draft proposals
        n_acc = torch.cumprod((g[:, :L - 1] == p).long(), dim=1).sum(dim=1)[:, None]
        corr = torch.gather(g, 1, n_acc)
        pfull = torch.nn.functional.pad(p, (0, 1))
        return torch.where(j < n_acc, pfull,
                           torch.where(j == n_acc, corr, torch.full_like(pfull, -1)))

    def _capture_decode(self) -> None:
        """Warm the step up on a side stream, then capture it, inside the
        watchdog's ``serve_decode`` scope.  The buffers hold zeros at the
        engine's own capture, so the warm-up writes only the null block.
        A failed capture raises: the engine never falls back to eager."""
        watch = (contextlib.nullcontext() if self.watchdog is None
                 else self.watchdog.watch("serve_decode", step=self._step))
        with watch:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._decode_step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._logits, self._next = self._decode_step()
            self.graph_captures += 1
            if self.watchdog is not None:
                self.watchdog.on_capture(time.perf_counter() - t0)

    def _run_decode_step(self) -> None:
        """Replay the captured step (eager on the CPU); the results land in
        ``self._logits`` and ``self._next``."""
        if self._graph is None:
            self._logits, self._next = self._decode_step()
        else:
            self._graph.replay()
            self.graph_replays += 1

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Tokens drawn from ``filter_logits`` of ``logits [..., V]``."""
        probs = torch.softmax(filter_logits(logits, self.temperature, self.top_k,
                                            self.top_p), dim=-1)
        return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=self._gen).reshape(probs.shape[:-1])

    # ------------------------------------------------------------------ time
    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self._time_fn()
        return self._time_fn() - self._t0

    # ---------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        cap = self.pool.capacity_tokens
        P = len(req.prompt)
        limit = cap - P + 1 - self.gamma
        if P > cap or limit < 1:
            raise ValueError(f"prompt of {P} tokens does not fit a {cap}-token "
                             f"block table (gamma={self.gamma})")
        req.max_new_tokens = min(req.max_new_tokens, limit)
        now = self._now()   # one stamp: tracer submit_t == arrival_time
        if self.trace is not None:
            req.trace_ctx = self.trace.on_submit(req.rid, now, priority=req.priority)
        self.sched.submit(req, now=now)

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def _prefill(self, slot: int, req: Request) -> None:
        P = len(req.prompt)
        ok = self.pool.ensure(req.rid, P)
        assert ok, "admission checked block availability"
        C = self.chunk_size
        table = torch.from_numpy(self.pool.table([req.rid])).to(self.device, torch.int64)
        chunk = np.zeros((1, C), np.int64)
        t_marks = [self._now()] if self.trace is not None else None
        for lo in range(0, P, C):
            # Lanes past the prompt carry token 0 at positions past the
            # committed window: they write garbage that decode
            # overwrites before the mask exposes it.
            valid = min(C, P - lo)
            chunk[0, :valid] = req.prompt[lo:lo + valid]
            chunk[0, valid:] = 0
            pos = torch.arange(lo, lo + C, device=self.device)[None, :]
            tokens = torch.from_numpy(chunk).to(self.device)
            logits = self.model(tokens, self.pk, self.pv, table, pos)
            if self.draft is not None:
                self.draft(tokens, self.dpk, self.dpv, table, pos)
            if t_marks is not None:
                t_marks.append(self._now())   # chunk dispatch boundary
        last = logits[0, valid - 1]
        tok = torch.argmax(last) if self.temperature <= 0 else self._sample(last)
        seed = int(tok)                  # the prefill's one host sync
        now = self._now()
        if t_marks is not None:
            # the host sync folds into the last chunk's span; the prefill's
            # end mark is the first-token stamp below, so the tracer's TTFT
            # equals the engine's sample exactly.
            t_marks[-1] = now
            self.trace.on_prefill(req.rid, t_marks, redo=req.first_token_time is not None)
        if req.first_token_time is None:
            req.first_token_time = now
            self.ttft_samples.append(now - req.arrival_time)
        self._emit(slot, req, seed, now, first=True)
        self._offsets[slot] = P
        self._last[slot] = seed
        self._last_emit[slot] = now
        if req.done:
            self._finish(slot)

    # ----------------------------------------------------------------- emit
    def _emit(self, slot: int, req: Request, token: int, now: float,
              first: bool = False) -> None:
        req.generated.append(token)
        self.total_tokens += 1
        if self.trace is not None:
            self.trace.on_emit(req.rid, now, first)
        if self.stream is not None:
            self.stream(req.rid, token, "first" if first else "token")

    def _finish(self, slot: int) -> None:
        req = self.sched.finish(slot, now=self._now())
        self.pool.free(req.rid)
        self._offsets[slot] = 0
        self._last[slot] = 0
        if self.trace is not None:
            self.trace.on_complete(req.rid, req.finish_time, tokens=len(req.generated),
                                   preemptions=req.preemptions)
        self.finished.append(req)

    # ------------------------------------------------------------ preemption
    def _preempt(self, slot: int) -> None:
        req = self.sched.slots[slot]
        self.pool.free(req.rid)
        self._offsets[slot] = 0
        self._last[slot] = 0
        self.sched.preempt(slot)
        if self.trace is not None:
            self.trace.on_preempt(req.rid, self._now())
        if self.obs is not None:
            self.obs.log_event("serve_preempt", step=self._step, rid=req.rid)

    def _ensure_or_preempt(self, slot: int, rid, need_tokens: int,
                           protect: Sequence[int] = ()) -> bool:
        """Grow ``rid`` to ``need_tokens``; on exhaustion preempt victims
        (possibly the requester itself, never a ``protect`` slot) until
        it fits or the requester is gone.  Returns False when the
        requesting slot was evicted."""
        while not self.pool.ensure(rid, need_tokens):
            victim = self.sched.pick_victim(protect=protect)
            if victim is None:
                return False
            self._preempt(victim)
            if victim == slot:
                return False
        return True

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One engine iteration; returns tokens emitted."""
        t_start = self._now()
        self._step += 1
        if self.chaos is not None:
            self.chaos.on_step(self, self._step)

        # admission: continuous fills free lanes anytime; static (the
        # naive baseline) only opens the door once the whole wave drains.
        if self.mode == "continuous" or not self.sched.active:
            # Blocks are only allocated at prefill, below — so each
            # candidate must be probed against the free count minus what
            # earlier admits in this same loop have already pledged.
            pledged = 0

            def can_admit(r: Request) -> bool:
                nonlocal pledged
                need = self.pool.blocks_needed(len(r.prompt))
                if self.pool.free_blocks - pledged < need:
                    return False
                pledged += need
                return True

            for slot, req in self.sched.admit(can_admit):
                if self.trace is not None:
                    self.trace.on_admit(req.rid, self._now())
                self._prefill(slot, req)

        emitted = 0
        active = list(self.sched.active)
        if active:
            grow = self.gamma + 1
            live = []
            held = set()
            for slot, req in active:
                if self.sched.slots[slot] is not req:
                    continue          # evicted by an earlier lane's growth
                # protect already-validated lanes: a later lane's growth
                # must never evict a slot this same decode will read.
                if self._ensure_or_preempt(slot, req.rid, int(self._offsets[slot]) + grow,
                                           protect=held):
                    live.append((slot, req))
                    held.add(slot)
            if live:
                emitted += self._decode(live)

        if self.pool.fragmentation_pct() > self.defrag_threshold_pct:
            t_df = self._now() if self.trace is not None else 0.0
            self._defrag()
            if self.trace is not None:
                self.trace.on_defrag(t_df, self._now())

        if emitted or active:
            self._log_metrics(self._now() - t_start, emitted)
        return emitted

    @torch.no_grad()
    def _decode(self, live) -> int:
        t_dec = self._now() if self.trace is not None else 0.0
        sids = [None] * self.max_batch
        for slot, req in live:
            sids[slot] = req.rid
        self._d_table.copy_(torch.from_numpy(self.pool.table(sids)))
        self._d_tokens.copy_(torch.from_numpy(self._last))
        self._d_offsets.copy_(torch.from_numpy(self._offsets))
        self._run_decode_step()
        self.decode_iterations += 1
        out = self._next if self.temperature <= 0 else self._sample(self._logits)
        arr = out.cpu().numpy()        # the one host sync of the iteration
        now = self._now()
        emitted = 0
        for slot, req in live:
            toks = (arr[slot][arr[slot] >= 0].tolist()
                    if arr.ndim == 2 else [int(arr[slot])])
            if self.trace is not None:
                self.trace.on_decode(req.rid, t_dec, now, len(toks))
            gap = now - self._last_emit[slot]
            for t in toks:
                self._emit(slot, req, t, now)
                self.itl_samples.append(gap / len(toks))
                emitted += 1
                if req.done:
                    break
            self._offsets[slot] += len(toks)
            self._last[slot] = req.generated[-1]
            self._last_emit[slot] = now
            if req.done:
                self._finish(slot)
        return emitted

    def _defrag(self) -> None:
        perm = self.pool.defrag()
        if np.array_equal(perm, np.arange(self.pool.n_blocks)):
            return
        p = torch.from_numpy(perm).to(self.device, torch.int64)
        apply_permutation(self.pk, p)
        apply_permutation(self.pv, p)
        if self.draft is not None:
            apply_permutation(self.dpk, p)
            apply_permutation(self.dpv, p)
        if self.obs is not None:
            self.obs.log_event("serve_defrag", step=self._step,
                               defrags=self.pool.defrags)

    # -------------------------------------------------------------- metrics
    def _log_metrics(self, step_time: float, emitted: int) -> None:
        if self.obs is None:
            return
        now = max(self._now(), 1e-9)
        extra = {
            "serving": 1.0,
            "queue_depth": float(self.sched.queue_depth),
            "active_seqs": float(len(self.sched.active)),
            "kv_occupancy_pct": self.pool.occupancy_pct(),
            "kv_frag_pct": self.pool.fragmentation_pct(),
            "preemptions": float(self.sched.preemptions),
            "requests_completed": float(self.sched.completed),
            "tokens_per_s": self.total_tokens / now,
        }
        for name, samples in (("ttft", self.ttft_samples),
                              ("itl", self.itl_samples)):
            for q in (0.5, 0.95, 0.99):
                v = _pct_ms(samples, q)
                if v is not None:
                    extra[f"{name}_p{int(q * 100)}_ms"] = v
        if self.trace is not None:
            extra.update(self.trace.step_fields())
        self.obs.log_step(self._step, step_time, n_items=emitted, extra=extra)
        self._drain_traces()

    def _drain_traces(self) -> None:
        """Lazy flush: book completed trace records as ``reqtrace``
        ft_events, one per request, once per step — never per token."""
        if self.trace is None or self.obs is None:
            return
        for ev in self.trace.drain():
            self.obs.log_event("reqtrace", step=self._step, **ev)

    # ------------------------------------------------------------------- run
    def run(self, load: List, max_steps: int = 100000) -> Dict[str, Any]:
        """Drive a loadgen trace to completion: submit each request when
        its arrival time passes on the engine clock, step until drained."""
        pending = sorted(load, key=lambda x: x[0])
        i = 0
        for _ in range(max_steps):
            now = self._now()
            while i < len(pending) and pending[i][0] <= now:
                self.submit(pending[i][1])
                i += 1
            if not self.sched.active and not self.sched.queue_depth:
                if i >= len(pending):
                    break
                self._sleep_fn(max(min(pending[i][0] - self._now(), 1e-3), 0.0))
                continue
            self.step()
        # final drain: a request that completes on the run's last step (or
        # a step whose metrics record was skipped) must still land.
        self._drain_traces()
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        wall = max(self._now(), 1e-9)
        out = {
            "mode": self.mode,
            "completed": self.sched.completed,
            "tokens": self.total_tokens,
            "wall_s": wall,
            "tokens_per_s": self.total_tokens / wall,
            "preemptions": self.sched.preemptions,
            "defrags": self.pool.defrags,
            "alloc_failures": self.pool.alloc_failures,
            "steps": self._step,
        }
        for name, samples in (("ttft", self.ttft_samples),
                              ("itl", self.itl_samples)):
            for q in (0.5, 0.95, 0.99):
                out[f"{name}_p{int(q * 100)}_ms"] = _pct_ms(samples, q)
        return out


def init_lm_params(vocab_size: int, d_model: int, n_heads: int, n_layers: int,
                   seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random-init f32 params for the paged model: the state dict of a
    ``TransformerLM`` initialised by ``init_weights`` from a
    ``torch.Generator`` seeded with ``seed`` (the same names, so either
    model loads it)."""
    model = TransformerLM(vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
                          n_layers=n_layers, dtype=torch.float32, device=device)
    model.init_weights(torch.Generator(device=model.device).manual_seed(seed))
    return model.state_dict()
