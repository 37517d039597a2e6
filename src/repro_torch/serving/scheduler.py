"""Pluggable request scheduling policies for the serving engine.

All admission / ordering / eviction *decisions* live here; the engine keeps
only the *mechanics* (prefill protocol, slot state, KV reclaim). A policy is
a queue with an opinion:

* **FCFSPolicy** — arrival order, never preempts. Bit-identical to the
  single hardwired deque the engine grew up with: ``peek`` is the old
  ``waiting[0]``, ``pop`` the old ``popleft``, and head-of-line blocking is
  preserved on purpose (the parity matrix holds across the refactor).
* **PriorityPolicy** — QoS classes (``interactive`` > ``batch`` by
  default, then ``priority`` then arrival within a class) with optional
  per-class *token budgets*: a class whose in-flight tokens
  (prompt + max_tokens of every admitted request) exceed its budget stops
  admitting until sequences finish, so a batch flood cannot occupy every
  slot even before preemption enters the picture. May select a victim:
  the most recently admitted running request of the lowest-ranked class
  strictly below the head's class (LIFO keeps the restore cheap — the
  youngest victim has published the fewest pages).
* **EDFPolicy** — SLA-aware earliest-deadline-first on TTFT deadlines
  (``InferenceRequest.deadline``, absolute clock time; requests without a
  deadline sort last, FIFO among themselves). May preempt the running
  request with the *latest* deadline when the head's deadline is strictly
  earlier.

Preemption itself (page reclaim, requeue, recompute-via-prefix-cache
restore) is engine machinery — see ``ContinuousBatchingEngine.preempt`` —
policies only ever *choose*. ``select_victim(head, running)`` receives the
blocked head request (or ``None`` under pure page pressure) plus the
engine's running view ``[(request_id, request, n_output_tokens,
n_preemptions), ...]`` in admission order, and returns a ``request_id``
or ``None``.
"""
from __future__ import annotations

from collections import deque

from repro_torch.serving.request import InferenceRequest

QOS_INTERACTIVE = "interactive"
QOS_BATCH = "batch"
# lower rank = more important; unknown classes rank with batch
DEFAULT_CLASS_RANK = {QOS_INTERACTIVE: 0, QOS_BATCH: 1}


def class_rank(qos: str) -> int:
    return DEFAULT_CLASS_RANK.get(qos, DEFAULT_CLASS_RANK[QOS_BATCH])


def request_tokens(req: InferenceRequest) -> int:
    """Budget charge for one admitted request: its whole KV footprint."""
    return len(req.prompt_tokens) + req.sampling.max_tokens


class SchedulingPolicy:
    """Queue + admission-order + victim-selection interface.

    The engine calls, per step: ``peek`` (may I admit this next?), ``pop``
    (admission committed), ``on_admitted`` / ``on_released`` (budget
    accounting), and — only when preemption is enabled —
    ``select_victim``. ``add`` enqueues both fresh requests and preempted
    victims re-entering the queue (the engine keeps the victim's partial
    output elsewhere; to the policy a requeued victim is just a request of
    its class again).
    """

    name = "base"

    def add(self, req: InferenceRequest) -> None:
        raise NotImplementedError

    def remove(self, request_id: str) -> InferenceRequest | None:
        """Drop a queued request (abort). Returns it, or None if absent."""
        raise NotImplementedError

    def peek(self) -> InferenceRequest | None:
        """Next admission candidate (None = nothing eligible)."""
        raise NotImplementedError

    def pop(self) -> InferenceRequest:
        """Commit admission of the current ``peek()`` result."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def queue_depth(self) -> int:
        return len(self)

    def snapshot(self) -> list[InferenceRequest]:
        """Queued requests in admission order (introspection only)."""
        raise NotImplementedError

    def requeue(self, req: InferenceRequest) -> None:
        """Re-enqueue a preempted victim. Defaults to ``add``; policies may
        rank victims ahead of fresh arrivals of the same class (their pages
        are parked in the prefix-cache LRU — the sooner they restore, the
        cheaper it is)."""
        self.add(req)

    # -- lifecycle feedback (budget accounting; default: none) ---------------
    def on_admitted(self, req: InferenceRequest) -> None:
        pass

    def on_released(self, req: InferenceRequest) -> None:
        """Admitted request left the engine (finished/aborted/preempted)."""
        pass

    # -- preemption ----------------------------------------------------------
    def select_victim(self, head: InferenceRequest | None,
                      running: list[tuple[str, InferenceRequest, int, int]]
                      ) -> str | None:
        """Pick a running request to preempt so ``head`` (a blocked
        higher-urgency admission, or None under pure page pressure) can
        make progress. ``running`` entries are ``(request_id, request,
        n_output_tokens, n_preemptions)`` in admission order. Base
        policies never preempt."""
        return None


class FCFSPolicy(SchedulingPolicy):
    """Strict arrival order — the pre-refactor engine behavior."""

    name = "fcfs"

    def __init__(self):
        self._q: deque[InferenceRequest] = deque()

    def add(self, req: InferenceRequest) -> None:
        self._q.append(req)

    def remove(self, request_id: str) -> InferenceRequest | None:
        for i, r in enumerate(self._q):
            if r.request_id == request_id:
                del self._q[i]
                return r
        return None

    def peek(self) -> InferenceRequest | None:
        return self._q[0] if self._q else None

    def pop(self) -> InferenceRequest:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def snapshot(self) -> list[InferenceRequest]:
        return list(self._q)

    def requeue(self, req: InferenceRequest) -> None:
        self._q.appendleft(req)


class PriorityPolicy(SchedulingPolicy):
    """QoS classes with optional per-class token budgets.

    ``class_order``: class names from most to least important (requests of
    unlisted classes are appended at batch rank). ``token_budgets``: class
    -> max in-flight tokens admitted at once (None / missing = unlimited).
    Within a class: lower ``priority`` first, then arrival order.
    """

    name = "priority"

    def __init__(self, class_order: tuple[str, ...] = (QOS_INTERACTIVE,
                                                       QOS_BATCH),
                 token_budgets: dict[str, int] | None = None):
        self.class_order = tuple(class_order)
        self.token_budgets = dict(token_budgets or {})
        self._queues: dict[str, list[InferenceRequest]] = \
            {c: [] for c in self.class_order}
        self._seq = 0                       # arrival tiebreak
        self._rseq = -(1 << 40)             # requeue tiebreak (before fresh)
        self._order: dict[str, int] = {}    # request_id -> arrival seq
        self._in_flight: dict[str, int] = {c: 0 for c in self.class_order}

    def _class_of(self, req: InferenceRequest) -> str:
        return req.qos if req.qos in self._queues else self.class_order[-1]

    def add(self, req: InferenceRequest) -> None:
        if req.request_id not in self._order:
            self._order[req.request_id] = self._seq
            self._seq += 1
        q = self._queues[self._class_of(req)]
        q.append(req)
        q.sort(key=lambda r: (r.priority, self._order[r.request_id]))

    def remove(self, request_id: str) -> InferenceRequest | None:
        for q in self._queues.values():
            for i, r in enumerate(q):
                if r.request_id == request_id:
                    del q[i]
                    self._order.pop(request_id, None)
                    return r
        return None

    def _within_budget(self, cls: str, req: InferenceRequest) -> bool:
        budget = self.token_budgets.get(cls)
        if budget is None:
            return True
        if self._in_flight[cls] == 0:
            # an idle class always gets its head request through, even one
            # bigger than the whole budget — a budget caps CONCURRENCY, it
            # must never make a request permanently inadmissible (the
            # engine would otherwise spin on has_work() forever)
            return True
        return self._in_flight[cls] + request_tokens(req) <= budget

    def peek(self) -> InferenceRequest | None:
        for cls in self.class_order:
            q = self._queues[cls]
            if q and self._within_budget(cls, q[0]):
                return q[0]
        return None

    def pop(self) -> InferenceRequest:
        head = self.peek()
        assert head is not None, "pop() on an empty/over-budget queue"
        self._queues[self._class_of(head)].remove(head)
        self._order.pop(head.request_id, None)
        return head

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def snapshot(self) -> list[InferenceRequest]:
        return [r for c in self.class_order for r in self._queues[c]]

    def requeue(self, req: InferenceRequest) -> None:
        # victims sort before fresh arrivals of the same priority, FIFO
        # among themselves (negative arrival keys, increasing)
        self._order[req.request_id] = self._rseq
        self._rseq += 1
        q = self._queues[self._class_of(req)]
        q.append(req)
        q.sort(key=lambda r: (r.priority, self._order[r.request_id]))

    def on_admitted(self, req: InferenceRequest) -> None:
        self._in_flight[self._class_of(req)] += request_tokens(req)

    def on_released(self, req: InferenceRequest) -> None:
        cls = self._class_of(req)
        self._in_flight[cls] -= request_tokens(req)
        assert self._in_flight[cls] >= 0, f"budget underflow for {cls!r}"

    def select_victim(self, head, running) -> str | None:
        # among the WORST class strictly below the head's class, ROTATE:
        # fewest-preempted first, then most recently admitted. Pure LIFO
        # would evict the same victim every time a burst of urgent work
        # lands — that one sequence then drains the whole run alone in a
        # near-empty (slow) batch, which costs more total throughput than
        # spreading the delay across victims. Under pure page pressure
        # (head=None) any class may be shed.
        floor = class_rank(head.qos) if head is not None else -1
        victim, victim_key = None, None
        for i, (rid, req, _n_out, n_pre) in enumerate(running):
            r = class_rank(req.qos)
            if r <= floor:
                continue
            key = (r, -n_pre, i)    # worst class, least-evicted, youngest
            if victim_key is None or key > victim_key:
                victim, victim_key = rid, key
        return victim


class EDFPolicy(SchedulingPolicy):
    """Earliest-deadline-first on TTFT deadlines (absolute clock time).

    Requests without a deadline sort after every deadlined request, FIFO
    among themselves — so EDF degrades to FCFS for untagged traffic.
    """

    name = "edf"

    _NO_DEADLINE = float("inf")

    def __init__(self):
        self._q: list[InferenceRequest] = []
        self._seq = 0
        self._rseq = -(1 << 40)             # requeue tiebreak (before fresh)
        self._order: dict[str, int] = {}

    @classmethod
    def _deadline(cls, req: InferenceRequest) -> float:
        return cls._NO_DEADLINE if req.deadline is None else req.deadline

    def add(self, req: InferenceRequest) -> None:
        if req.request_id not in self._order:
            self._order[req.request_id] = self._seq
            self._seq += 1
        self._q.append(req)
        self._q.sort(key=lambda r: (self._deadline(r),
                                    self._order[r.request_id]))

    def remove(self, request_id: str) -> InferenceRequest | None:
        for i, r in enumerate(self._q):
            if r.request_id == request_id:
                del self._q[i]
                self._order.pop(request_id, None)
                return r
        return None

    def peek(self) -> InferenceRequest | None:
        return self._q[0] if self._q else None

    def pop(self) -> InferenceRequest:
        req = self._q.pop(0)
        self._order.pop(req.request_id, None)
        return req

    def __len__(self) -> int:
        return len(self._q)

    def snapshot(self) -> list[InferenceRequest]:
        return list(self._q)

    def requeue(self, req: InferenceRequest) -> None:
        # a preempted victim sorts before fresh arrivals of the SAME
        # deadline (its pages are parked in the prefix-cache LRU); an
        # earlier deadline elsewhere in the queue still wins
        self._order[req.request_id] = self._rseq
        self._rseq += 1
        self._q.append(req)
        self._q.sort(key=lambda r: (self._deadline(r),
                                    self._order[r.request_id]))

    def select_victim(self, head, running) -> str | None:
        # shed the running request with the most slack (latest deadline,
        # most recent on ties); with a blocked head the victim's deadline
        # must be strictly LATER than the head's
        floor = self._deadline(head) if head is not None else -1.0
        victim, victim_d = None, floor
        for rid, req, _n_out, _n_pre in running:   # admission-ordered
            d = self._deadline(req)
            if d > floor and d >= victim_d:
                victim, victim_d = rid, d
        return victim


POLICIES = {p.name: p for p in (FCFSPolicy, PriorityPolicy, EDFPolicy)}


def make_policy(spec: str | SchedulingPolicy | None,
                **kwargs) -> SchedulingPolicy:
    """Build a policy from a name ('fcfs' | 'priority' | 'edf'), pass an
    instance through unchanged, or default to FCFS."""
    if spec is None:
        return FCFSPolicy()
    if isinstance(spec, SchedulingPolicy):
        return spec
    if spec not in POLICIES:
        raise ValueError(f"unknown scheduling policy {spec!r} "
                         f"(have {sorted(POLICIES)})")
    return POLICIES[spec](**kwargs)
