"""Speculative decoding: draft-model proposals, target-model rejection
sampling (Leviathan et al. 2023 / Chen et al. 2023).  The port of
``pytorch_distributed_tpu/models/speculative.py``.

A cheap draft proposes ``gamma`` tokens one at a time; the target scores
the whole ``[1, gamma+1]`` block in one cached forward (dense masked
attention over the cache, which takes a block of any length at any
index); rejection sampling keeps the output distributed exactly as
target-only sampling:

- accept draft token x_i with probability min(1, p_i(x_i)/q_i(x_i));
- at the first rejection, emit a sample of norm(max(p_i − q_i, 0));
- if all gamma survive, sample a bonus token from the target's last
  distribution: up to gamma+1 tokens per target pass.

p and q are the post-filter sampling distributions (the port's
``filter_logits``), so temperature, top-k and top-p compose.  Greedy
(temperature 0) uses one-hot p and q: the output is the target's own
greedy stream, whatever the draft.

The host logic is the JAX module's, line for line: ``_accept``,
``_resample``, ``_dist`` and the order of the draws from a numpy
``default_rng(seed)``, so the sampled stream can be held against JAX's.
Cache bookkeeping: the scoring pass writes k/v for every proposed token;
on a rejection each layer's cache ``index`` is rewound to the accepted
prefix, and the stale k/v beyond it are overwritten before any query can
attend to them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.generate import filter_logits
from pytorch_distributed_tpu_torch.models.quant import quantize_lm
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def _accept(p: np.ndarray, q: np.ndarray, x: int, rng, greedy: bool) -> bool:
    """Accept draft token ``x`` with probability min(1, p(x)/q(x)).  Greedy
    one-hots reduce exactly to argmax equality (no rng draw)."""
    p_x, q_x = p[x], q[x]
    if greedy:
        return p_x > 0.0
    return rng.uniform() < min(1.0, p_x / max(q_x, 1e-20))


def _resample(p: np.ndarray, q: np.ndarray, rng, greedy: bool) -> int:
    """Sample from the residual norm(max(p − q, 0)); degenerate p == q
    falls back to p itself (the residual is then undefined 0/0)."""
    resid = np.maximum(p - q, 0.0)
    total = resid.sum()
    if total <= 0:
        resid, total = p, p.sum()
    resid = resid / total
    return int(np.argmax(resid)) if greedy else int(rng.choice(len(resid), p=resid))


def _dist(logits_row: torch.Tensor, temperature: float, top_k: int,
          top_p: float) -> np.ndarray:
    """``[V]`` logits -> ``[V]`` float64 probabilities of the actual
    sampling distribution (one-hot argmax when greedy)."""
    if temperature <= 0.0:
        probs = np.zeros(logits_row.shape[-1], np.float64)
        probs[int(np.argmax(logits_row.float().cpu().numpy()))] = 1.0
        return probs
    filt = filter_logits(logits_row, temperature, top_k, top_p)
    probs = torch.softmax(filt, dim=-1).cpu().numpy().astype(np.float64)
    # Renormalized in float64: an f32 softmax sum misses 1 by up to ~1e-7
    # at vocab 32k, past numpy Generator.choice's tolerance.
    return probs / probs.sum()


def _as_model(model, cfg: Optional[dict], dtype, quant: str, device) -> TransformerLM:
    """``model`` itself, or a ``TransformerLM`` built from ``cfg`` and
    ``dtype`` holding the state dict ``model``; quantized when ``quant``
    asks and it is not yet."""
    if not isinstance(model, TransformerLM):
        if cfg is None:
            raise ValueError("a state dict needs its cfg (vocab_size, d_model, n_heads, "
                             "n_layers)")
        built = TransformerLM(**cfg, dtype=dtype or torch.float32, device=device)
        built.load_state_dict(model)
        model = built
    if quant and not model.quant:
        model = quantize_lm(model)
    return model


def _set_cache_index(cache, value: int) -> None:
    """Rewind every layer's cache index (the k/v beyond it are dead)."""
    for layer in cache:
        layer.index = value


@torch.no_grad()
def speculative_generate(target, draft, prompt, max_new_tokens: int, *,
                         target_cfg: Optional[dict] = None,
                         draft_cfg: Optional[dict] = None, gamma: int = 4,
                         dtype: Optional[torch.dtype] = None, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                         quant: str = "", draft_quant: str = "", device="cuda"
                         ) -> Tuple[torch.Tensor, dict]:
    """Decode ``max_new_tokens`` continuations of a ``[1, P]`` prompt with
    draft speculation.

    ``target`` and ``draft`` are ``TransformerLM`` modules, or state dicts
    built into models from ``target_cfg``/``draft_cfg`` (vocab_size,
    d_model, n_heads, n_layers; the vocabularies must match) and ``dtype``
    on ``device``.  ``quant``/``draft_quant`` = "int8" quantize a full-
    precision model first.  Returns ``(tokens [1, max_new_tokens] int32,
    stats)``; stats holds the target passes, the tokens, the mean accepted
    per round and the tokens per target pass.  Greedy output is the
    target's own greedy stream; sampling draws from a numpy
    ``default_rng(seed)``.
    """
    device = resolve_device(device if not isinstance(target, TransformerLM)
                            else target.device)
    target = _as_model(target, target_cfg, dtype, quant, device)
    draft = _as_model(draft, draft_cfg, dtype, draft_quant, device)
    V = target.embed.num_embeddings
    if draft.embed.num_embeddings != V:
        raise ValueError("target and draft must share a vocabulary")
    prompt = torch.as_tensor(prompt, device=target.device)
    if prompt.shape[0] != 1:
        raise ValueError("speculative decode is batch-1 (serving latency)")
    P = prompt.shape[1]
    max_len = P + max_new_tokens + gamma + 1  # scoring may overshoot
    rng = np.random.default_rng(seed)
    greedy = temperature <= 0

    def dist(row):
        return _dist(row, temperature, top_k, top_p)

    def pick(probs):
        return int(rng.choice(V, p=probs)) if temperature > 0 else int(np.argmax(probs))

    def one(tok):
        return torch.full((1, 1), tok, dtype=torch.int64, device=target.device)

    # Prefill both caches (dense attention, as the JAX block apply); the
    # target's last-position logits seed x_cur.
    t_cache = target.new_cache(1, max_len)
    d_cache = draft.new_cache(1, max_len)
    t_logits = target(prompt, cache=t_cache)
    draft(prompt, cache=d_cache)
    x_cur = pick(dist(t_logits[0, -1]))

    out = [x_cur]
    n = P  # tokens whose k/v are final in both caches
    target_passes = 1
    accepted_hist = []
    while len(out) < max_new_tokens:
        g = min(gamma, max_new_tokens - len(out))
        # The draft proposes gamma tokens (one scoring shape; extras are
        # discarded), keeping its q distributions.
        d_tokens, q_dists = [], []
        tok = x_cur
        for _ in range(gamma):
            dl = draft(one(tok), cache=d_cache)
            q = dist(dl[0, -1])
            tok = pick(q)
            d_tokens.append(tok)
            q_dists.append(q)
        # The target scores [x_cur, d_1..d_gamma] in one pass.
        block = torch.tensor([[x_cur] + d_tokens], dtype=torch.int64, device=target.device)
        tl = target(block, cache=t_cache)
        target_passes += 1
        p_dists = [dist(tl[0, i]) for i in range(gamma + 1)]
        accepted = 0
        for i in range(g):
            x_i = d_tokens[i]
            if not _accept(p_dists[i], q_dists[i], x_i, rng, greedy=greedy):
                x_cur = _resample(p_dists[i], q_dists[i], rng, greedy=greedy)
                break
            accepted += 1
            out.append(x_i)
            if len(out) >= max_new_tokens:
                break
        else:
            # Every proposal survived: a bonus token from the target's last
            # distribution.  The draft never consumed its own last proposal;
            # feed it so its cache has no hole at position n + gamma.
            draft(one(d_tokens[-1]), cache=d_cache)
            x_cur = pick(p_dists[g])
        accepted_hist.append(accepted)
        if len(out) < max_new_tokens:
            out.append(x_cur)
        # Rewind: the scoring pass advanced both caches past the accepted
        # prefix; only the index moves back.
        n += 1 + accepted
        _set_cache_index(t_cache, n)
        _set_cache_index(d_cache, n)

    tokens = out[:max_new_tokens]
    stats = {
        "target_passes": target_passes,
        "tokens": len(tokens),
        "mean_accepted": float(np.mean(accepted_hist)) if accepted_hist else 0.0,
        "tokens_per_target_pass": len(tokens) / max(target_passes, 1),
    }
    return torch.tensor([tokens], dtype=torch.int32, device=target.device), stats
