"""Elastic membership: epochs, re-mesh decisions, and exact state
re-sharding across world sizes — the port of
``pytorch_distributed_tpu/ft/elastic.py`` (the same files and decisions).

Checkpoint resume survives a failure by dying and resuming at the same
world size; production fleets shrink and grow.  This module supplies the
three pieces for that:

- **Membership coordination.**  ``ElasticCoordinator`` maintains a
  monotonically increasing *membership epoch* over a shared heartbeat
  directory: it folds ``obs.heartbeat.find_stragglers``' dead/slow split
  into leave decisions (dead → evict, slow → keep-but-flag — a dragging
  host rate-limits the mesh but does not corrupt it) and admits ranks that
  filed a join request.  Every decision is an atomic ``membership.json``
  rewrite, and beats stamped with an older epoch are *stale incarnations*
  — a rank from a pre-re-mesh world must never read as live
  (``read_heartbeats(min_epoch=...)``).  ``ElasticSim`` implements the
  same ``poll()`` protocol in-process, driven by the chaos injectors, so
  single-process tests exercise the identical trainer path the
  file-based coordinator drives across real processes.

- **Rescale rules.**  On a world change N→M the run must decide what the
  global batch and LR mean now.  ``rule='none'`` holds the *global* batch
  constant (per-rank rows change; the gradient estimator — and therefore
  the LR — is untouched: the parity-fence default).  ``'linear'``/
  ``'sqrt'`` hold the *per-rank* batch constant (global batch scales with
  the world) and scale the LR by (M/N) or sqrt(M/N) — the Goyal et al. /
  Krizhevsky pairings.

- **Exact re-sharding.**  Checkpoints already prove params + param-shaped
  momentum restore across mesh shapes (gather-on-save).  What does NOT
  cross worlds for free is the explicit-path state whose *layout* bakes in
  n_data: ZeRO-WUS stacked momentum chunks ``(n, chunk)`` (buf and the
  quantized all-gather's agerr twin) re-grid losslessly — the flat
  concatenation of chunks IS the padded param vector, so truncate-and-
  re-chunk is exact (``regrid_wus_momentum``).  Stacked per-rank
  error-feedback residuals ``(n, *shape)`` are pending corrections whose
  *sum* is the semantic content (each rank adds its slot to its local
  gradient before quantizing); ``regrid_stacked_residual`` preserves that
  sum exactly by folding it into slot 0 of the new world.

The fleet arbiter (serving/router.py ``FleetArbiter``) drives the
coordinator today.  Wiring ``--elastic``, ``--min-ranks`` and
``--rescale-lr`` into the trainers' re-mesh is ROADMAP.md item A11's next
slice; until then those flags exit.

numpy (and torch, for tensor leaves) are imported lazily, so the
coordinator side stays stdlib-only, like obs/heartbeat.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Optional, Set, Tuple

from pytorch_distributed_tpu_torch.ft.chaos import ChaosInjector

MEMBERSHIP_NAME = "membership.json"
_JOIN_PREFIX = "join-"

RESCALE_RULES = ("none", "linear", "sqrt")


@dataclasses.dataclass(frozen=True)
class Membership:
    """One membership epoch: which ranks form the mesh right now."""

    epoch: int
    ranks: Tuple[int, ...]

    @property
    def world(self) -> int:
        return len(self.ranks)

    def to_json(self) -> dict:
        return {"epoch": int(self.epoch),
                "ranks": [int(r) for r in self.ranks]}

    @staticmethod
    def from_json(obj: dict) -> "Membership":
        return Membership(int(obj["epoch"]),
                          tuple(sorted(int(r) for r in obj["ranks"])))


@dataclasses.dataclass(frozen=True)
class MembershipChange:
    """A committed epoch transition (what the trainers act on)."""

    old: Membership
    new: Membership
    reason: str

    @property
    def kind(self) -> str:
        return "shrink" if self.new.world < self.old.world else "grow"


def atomic_write_json(path: str, obj: dict) -> None:
    """tmp + ``os.replace``: readers never observe a torn file (the same
    discipline checkpoint sidecars use — ft/integrity.py)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def split_liveness(flagged: Dict[int, str]) -> Tuple[Set[int], Set[int]]:
    """Partition ``find_stragglers``' reasons into ``(dead, slow)`` pids.

    Reuses the monitor's own classification strings rather than
    re-deriving the thresholds: *dead* ranks (stale beats — "dead or
    hung") are candidates for eviction; *slow* ranks (fresh beats, fat
    step-time EMA) stay members — they rate-limit the mesh but their
    state is intact, the "replace the host later" case."""
    dead = {pid for pid, why in flagged.items() if "dead or hung" in why}
    slow = {pid for pid, why in flagged.items()
            if pid not in dead and "slow rank" in why}
    return dead, slow


def rescale_lr(lr: float, old_world: int, new_world: int,
               rule: str = "none") -> float:
    """LR under a world change per the rescale rule (see module doc)."""
    if rule not in RESCALE_RULES:
        raise ValueError(
            f"rescale rule must be one of {RESCALE_RULES}, got {rule!r}")
    if rule == "none" or old_world == new_world:
        return lr
    ratio = new_world / old_world
    return lr * (ratio if rule == "linear" else ratio ** 0.5)


def rescale_batch(batch: int, old_world: int, new_world: int,
                  rule: str = "none") -> int:
    """Global batch under a world change: ``'none'`` holds it constant;
    the LR-scaling rules hold the *per-rank* batch constant instead."""
    if rule not in RESCALE_RULES:
        raise ValueError(
            f"rescale rule must be one of {RESCALE_RULES}, got {rule!r}")
    if rule == "none":
        return batch
    if batch % old_world:
        raise ValueError(
            f"global batch {batch} not divisible by world {old_world}")
    return (batch // old_world) * new_world


# ------------------------------------------------------- exact re-sharding

def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists/tuples (host trees of
    numpy arrays or CPU tensors; ``rest`` shares ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _host(leaf):
    """A leaf as an f32 numpy array (a CPU tensor through ``.numpy()``)."""
    import numpy as np

    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, np.float32)


def regrid_wus_momentum(host_momentum, params, n_new: int,
                        block: Optional[int] = None):
    """Re-grid stacked ZeRO-WUS optimizer state ``(n_old, chunk_old)`` →
    ``(n_new, chunk_new)``, exactly.

    The stacked layout is the padded flat param vector cut into n whole-
    block chunks (parallel/zero.py), so flattening, truncating to the true
    leaf size, and re-chunking for the new world is lossless — momentum
    round-trips N→M→N bit-exactly.  Applies the same transform to the
    quantized all-gather's ``agerr`` twin, whose flat layout is identical
    (per-position pending deltas of the padded param vector).  Leaves may
    be numpy arrays or CPU tensors; the result is numpy."""
    import numpy as np

    from pytorch_distributed_tpu_torch.ops import qcomm
    from pytorch_distributed_tpu_torch.parallel import zero as zero_lib

    blk = qcomm.DEFAULT_BLOCK if block is None else int(block)
    if not (isinstance(host_momentum, dict) and "buf" in host_momentum
            and set(host_momentum) <= {"buf", "agerr", "pending"}):
        raise ValueError("regrid_wus_momentum expects the stacked "
                         "{'buf': ...} WUS layout")

    def regrid(b, p):
        size = int(np.prod(tuple(p.shape), dtype=np.int64))
        flat = _host(b).reshape(-1)[:size]
        chunk = zero_lib.chunk_size(size, n_new, blk)
        out = np.zeros(n_new * chunk, np.float32)
        out[:size] = flat
        return out.reshape(n_new, chunk)

    out = {"buf": _tree_map(regrid, host_momentum["buf"], params)}
    if "agerr" in host_momentum:
        out["agerr"] = _tree_map(regrid, host_momentum["agerr"], params)
    return out


def regrid_stacked_residual(host_residual, n_new: int):
    """Re-grid stacked per-rank error-feedback residuals ``(n_old, *shape)``
    → ``(n_new, *shape)``, preserving the total pending correction.

    Each rank's slot is the quantization error it will add back to its
    local gradient contribution before the next sync; the collective sums
    contributions, so the *sum over slots* is the semantic content.  The
    new world carries that sum in slot 0 (zeros elsewhere) — exact in the
    only sense that survives a change of rank identity."""
    import numpy as np

    def regrid(leaf):
        arr = _host(leaf)
        total = arr.sum(axis=0)
        out = np.zeros((n_new,) + total.shape, np.float32)
        out[0] = total
        return out

    return _tree_map(regrid, host_residual)


# ---------------------------------------------------------- coordination

class ElasticSim:
    """In-process membership controller: the single-process stand-in for
    ``ElasticCoordinator`` that the chaos injectors drive.

    The trainers see one protocol — ``poll(step) -> MembershipChange?`` —
    so the tier-1 drills exercise the identical re-mesh path the
    file-based coordinator triggers on a real fleet.  ``min_ranks`` is the
    shrink floor: a loss that would take the world below it is *refused*
    (recorded in ``refused``), matching the coordinator's behavior."""

    def __init__(self, world: int, min_ranks: int = 1):
        if world < 1 or min_ranks < 1 or min_ranks > world:
            raise ValueError(
                f"need 1 <= min_ranks <= world, got min_ranks={min_ranks} "
                f"world={world}")
        self.min_ranks = int(min_ranks)
        self.membership = Membership(0, tuple(range(int(world))))
        self._desired: Set[int] = set(self.membership.ranks)
        self._reasons: list = []
        self.refused: list = []
        self.history: list = []

    def force_lose(self, rank: int, reason: str = "chaos") -> None:
        if rank in self._desired:
            if len(self._desired) - 1 < self.min_ranks:
                self.refused.append((int(rank), reason))
                return
            self._desired.discard(int(rank))
            self._reasons.append(f"lost rank {rank} ({reason})")

    def force_join(self, rank: int, reason: str = "chaos") -> None:
        if rank not in self._desired:
            self._desired.add(int(rank))
            self._reasons.append(f"rank {rank} joined ({reason})")

    def poll(self, step: int) -> Optional[MembershipChange]:  # noqa: ARG002
        if self._desired == set(self.membership.ranks):
            return None
        old = self.membership
        new = Membership(old.epoch + 1, tuple(sorted(self._desired)))
        reason = "; ".join(self._reasons) or "membership change"
        self._reasons = []
        self.membership = new
        chg = MembershipChange(old, new, reason)
        self.history.append(chg)
        return chg


class ElasticCoordinator:
    """File-based membership-epoch coordinator over a shared heartbeat
    directory (the multi-process real path; the fleet arbiter drives it).

    Liveness comes from the beats themselves: ``decide()`` reads the
    current epoch's heartbeats, runs ``find_stragglers``, evicts *dead*
    members (keeps *slow* ones), admits pending join requests, and — when
    membership actually changes — commits the new epoch atomically.
    Stdlib-only, like the heartbeat module: runs on a login node or in a
    cron job without touching the card."""

    def __init__(self, hb_dir: str, world: int, min_ranks: int = 1,
                 max_step_lag: int = 3, max_age_s: float = 60.0,
                 slow_ema_factor: float = 2.0):
        if min_ranks < 1 or min_ranks > world:
            raise ValueError(
                f"need 1 <= min_ranks <= world, got min_ranks={min_ranks} "
                f"world={world}")
        self.dir = hb_dir
        self.min_ranks = int(min_ranks)
        self.max_step_lag = int(max_step_lag)
        self.max_age_s = float(max_age_s)
        self.slow_ema_factor = float(slow_ema_factor)
        os.makedirs(hb_dir, exist_ok=True)
        self.path = os.path.join(hb_dir, MEMBERSHIP_NAME)
        if not os.path.exists(self.path):
            atomic_write_json(
                self.path,
                Membership(0, tuple(range(int(world)))).to_json())

    # -- membership state ---------------------------------------------
    def membership(self) -> Membership:
        with open(self.path) as f:
            return Membership.from_json(json.load(f))

    def _commit(self, new: Membership) -> None:
        atomic_write_json(self.path, new.to_json())

    # -- join protocol ------------------------------------------------
    def join_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"{_JOIN_PREFIX}{int(rank):05d}.json")

    def request_join(self, rank: int) -> None:
        """A restarted/new rank files its admission request (atomic; the
        next ``decide()`` folds it in and bumps the epoch)."""
        atomic_write_json(self.join_path(rank),
                          {"rank": int(rank), "t": time.time()})

    def pending_joins(self) -> Set[int]:
        out: Set[int] = set()
        for name in os.listdir(self.dir):
            if name.startswith(_JOIN_PREFIX) and name.endswith(".json"):
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        out.add(int(json.load(f)["rank"]))
                except (ValueError, KeyError, OSError):
                    continue
        return out

    # -- decisions ----------------------------------------------------
    def decide(self, now: Optional[float] = None,
               beats: Optional[Dict[int, dict]] = None,
               extra_dead: Optional[Set[int]] = None,
               ) -> Optional[MembershipChange]:
        """One coordination round → a committed ``MembershipChange`` or
        None.  ``beats`` is injectable for tests; by default the current
        epoch's heartbeats are read from ``hb_dir`` (older epochs are
        stale incarnations and never count as live).

        ``extra_dead``: ranks an external observer already declared dead
        — the live alert plane's ``dead_rank`` ft_events
        (``obs/alerts.py``).
        They merge into the same eviction set this round computes from
        heartbeats, so alert-driven eviction rides the one decision path
        (floor check, epoch bump, commit) instead of growing a second
        liveness policy."""
        from pytorch_distributed_tpu_torch.obs.heartbeat import (
            find_stragglers,
            read_heartbeats,
        )

        cur = self.membership()
        if beats is None:
            beats = read_heartbeats(self.dir, min_epoch=cur.epoch)
        flagged = find_stragglers(
            beats, now=now, max_step_lag=self.max_step_lag,
            max_age_s=self.max_age_s,
            slow_ema_factor=self.slow_ema_factor)
        dead, _slow = split_liveness(flagged)
        for r in (extra_dead or ()):
            r = int(r)
            dead.add(r)
            flagged.setdefault(r, "alert: dead_rank ft_event")
        # A member with NO beat at the current epoch yet is in flight
        # (just re-meshed), not dead — only a stale beat marks death.
        leave = {r for r in cur.ranks if r in dead}
        joins = {r for r in self.pending_joins() if r not in cur.ranks}
        survivors = (set(cur.ranks) - leave) | joins
        if survivors == set(cur.ranks):
            return None
        reasons = [f"evict rank {r}: {flagged[r]}" for r in sorted(leave)]
        reasons += [f"admit rank {r} (join request)" for r in sorted(joins)]
        if len(survivors) < self.min_ranks:
            # Refusing is itself a decision worth surfacing, but the
            # membership (and epoch) must not move below the floor.
            return None
        new = Membership(cur.epoch + 1, tuple(sorted(survivors)))
        self._commit(new)
        for r in joins:
            try:
                os.remove(self.join_path(r))
            except OSError:
                pass
        return MembershipChange(cur, new, "; ".join(reasons))


# -------------------------------------------------------- chaos injectors

class LoseRankAt(ChaosInjector):
    """Remove ``rank`` from the membership when the loop reaches
    ``at_step`` — the deterministic stand-in for a dead host.  Drives the
    trainer's elastic controller (``trainer.elastic``); a trainer without
    one ignores the injection (matching ``KillAt``'s rank gating)."""

    def __init__(self, at_step: int, rank: int, reason: str = "chaos"):
        self.at_step = int(at_step)
        self.rank = int(rank)
        self.reason = str(reason)
        self.fired = False

    def on_step(self, trainer, step: int) -> None:
        if not self.fired and step == self.at_step:
            self.fired = True
            ctl = getattr(trainer, "elastic", None)
            if ctl is not None:
                ctl.force_lose(self.rank, reason=self.reason)


class JoinRankAt(ChaosInjector):
    """Re-admit ``rank`` into the membership at ``at_step`` — the
    recovered-host half of the shrink/grow drill."""

    def __init__(self, at_step: int, rank: int, reason: str = "chaos"):
        self.at_step = int(at_step)
        self.rank = int(rank)
        self.reason = str(reason)
        self.fired = False

    def on_step(self, trainer, step: int) -> None:
        if not self.fired and step == self.at_step:
            self.fired = True
            ctl = getattr(trainer, "elastic", None)
            if ctl is not None:
                ctl.force_join(self.rank, reason=self.reason)
