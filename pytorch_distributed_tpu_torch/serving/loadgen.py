"""Seeded synthetic load for the serving engine: a copy of
``pytorch_distributed_tpu/serving/loadgen.py``, so that one seed gives the
same trace to both packages.

Poisson arrivals (exponential inter-arrival gaps at ``rate_rps``) with
mixed prompt/output-length distributions.  Everything flows from one
``np.random.default_rng(seed)``, so a trace is a pure function of its
config — a run replays the identical trace against both batching
modes, and the scheduler determinism tests replay it across runs.

The "mixed" profile is the serving-shaped one: mostly short outputs with
a long tail.  Static batching pays E[max over batch] per wave while
continuous batching pays E[length] per slot.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.serving.scheduler import Request

PROFILES = ("mixed", "uniform")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    n_requests: int = 32
    rate_rps: float = 50.0       # mean arrival rate (requests/second)
    profile: str = "mixed"
    vocab_size: int = 64
    prompt_min: int = 4
    prompt_max: int = 12
    short_min: int = 2           # "mixed": ~80% of outputs land here
    short_max: int = 8
    long_min: int = 32           # ...and ~20% here (the tail static pays for)
    long_max: int = 48
    long_frac: float = 0.2
    seed: int = 0


def generate_load(cfg: LoadConfig) -> List[Tuple[float, Request]]:
    """``[(arrival_time_s, Request)]`` sorted by arrival time."""
    if cfg.profile not in PROFILES:
        raise ValueError(f"unknown profile {cfg.profile!r}; "
                         f"expected {PROFILES}")
    rng = np.random.default_rng(cfg.seed)
    t = 0.0
    out: List[Tuple[float, Request]] = []
    for rid in range(cfg.n_requests):
        t += float(rng.exponential(1.0 / cfg.rate_rps))
        plen = int(rng.integers(cfg.prompt_min, cfg.prompt_max + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        if cfg.profile == "mixed" and rng.random() < cfg.long_frac:
            new = int(rng.integers(cfg.long_min, cfg.long_max + 1))
        else:
            new = int(rng.integers(cfg.short_min, cfg.short_max + 1))
        out.append((t, Request(rid=rid, prompt=prompt, max_new_tokens=new)))
    return out
