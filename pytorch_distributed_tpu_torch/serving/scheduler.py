"""Admission, slot assignment, and preempt-and-requeue for the serving
engine: a copy of ``pytorch_distributed_tpu/serving/scheduler.py``.

Pure host logic: requests queue FCFS or by priority, admit into
a fixed ``[B_max]`` slot array (the active mask the static-shape decode
step runs over), and — when the KV pool exhausts mid-decode — a victim
is preempted: its blocks freed, its generation discarded, the request
requeued at its original queue position (recompute semantics, the
restart-from-scratch half of vLLM's recompute-vs-swap choice; greedy
decoding makes the regenerated tokens identical).

Determinism contract (tier-1 tested): admission order, slot assignment,
and victim choice are pure functions of the submitted request sequence —
no wall clock, no dict-order dependence.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, List, Optional, Sequence, Tuple

POLICIES = ("fcfs", "priority")


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    priority: int = 0            # larger = more important ("priority" policy)
    arrival_time: float = 0.0    # stamped by Scheduler.submit (engine clock)
    # -- runtime state (engine-owned) --
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0
    # Propagatable trace identity (obs/reqtrace.TraceContext, or any
    # object with a ``hops`` list).  Duck-typed on purpose: serving/
    # stays import-free of obs/, and a router can hand in its own
    # context record — the scheduler just appends lifecycle hops.
    trace_ctx: Optional[Any] = None

    def _hop(self, name: str) -> None:
        if self.trace_ctx is not None:
            self.trace_ctx.hops.append(name)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    """Queue + fixed slot batch.  ``slots[i]`` is the Request decoding in
    batch lane ``i`` (None = free lane, inactive in the step's mask)."""

    def __init__(self, max_batch: int, policy: str = "fcfs"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.policy = policy
        self.slots: List[Optional[Request]] = [None] * self.max_batch
        self._heap: List[Tuple[tuple, int, Request]] = []
        self._seq = itertools.count()
        # heap tiebreaker: equal keys pop FIFO instead of falling through
        # to comparing Request objects (which defines no ordering)
        self._tiebreak = itertools.count()
        self._order: dict = {}       # rid -> submit sequence number
        self._admit_seq = itertools.count()
        self._admitted_at: dict = {}  # rid -> admission sequence (victim age)
        self.preemptions = 0
        self.admitted = 0
        self.completed = 0

    # ---------------------------------------------------------------- queue
    def submit(self, req: Request, now: float = 0.0) -> None:
        req.arrival_time = now
        self._order[req.rid] = next(self._seq)
        req._hop("queue")
        heapq.heappush(self._heap,
                       (self._key(req), next(self._tiebreak), req))

    def _key(self, req: Request) -> tuple:
        # A preempted request re-enters with its ORIGINAL submit order,
        # so requeue lands it ahead of everything that arrived after it.
        if self.policy == "priority":
            return (-req.priority, self._order[req.rid])
        return (self._order[req.rid],)

    @property
    def queue_depth(self) -> int:
        return len(self._heap)

    @property
    def active(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    # ------------------------------------------------------------ admission
    def admit(self, can_admit: Callable[[Request], bool]
              ) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue head while ``can_admit`` (the
        engine's block-availability probe) accepts.  Head-of-line
        blocking is deliberate: skipping over a too-big head request
        would starve it forever on a busy pool."""
        placed: List[Tuple[int, Request]] = []
        for slot in self.free_slots():
            if not self._heap:
                break
            req = self._heap[0][-1]
            if not can_admit(req):
                break
            heapq.heappop(self._heap)
            self.slots[slot] = req
            self._admitted_at[req.rid] = next(self._admit_seq)
            self.admitted += 1
            req._hop("admit")
            placed.append((slot, req))
        return placed

    # ----------------------------------------------------------- preemption
    def pick_victim(self, protect: Sequence[int] = ()) -> Optional[int]:
        """The slot to preempt when the pool exhausts: lowest priority
        first, then youngest admission (most recently admitted loses the
        least recomputation).  ``protect`` slots are exempt (e.g. the
        lane being prefilled this instant)."""
        candidates = [(r.priority, -self._admitted_at[r.rid], i)
                      for i, r in self.active if i not in protect]
        if not candidates:
            return None
        _, _, slot = min(candidates)
        return slot

    def preempt(self, slot: int) -> Request:
        """Evict ``slots[slot]``: discard its generation and requeue it
        (caller frees the KV blocks).  Returns the evicted request."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        self.slots[slot] = None
        self._admitted_at.pop(req.rid, None)
        req.generated = []
        req.preemptions += 1
        self.preemptions += 1
        req._hop("requeue")
        heapq.heappush(self._heap,
                       (self._key(req), next(self._tiebreak), req))
        return req

    def finish(self, slot: int, now: float = 0.0) -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        self.slots[slot] = None
        self._admitted_at.pop(req.rid, None)
        req.finish_time = now
        self.completed += 1
        req._hop("finish")
        return req
