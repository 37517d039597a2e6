"""Model instances: cold-start pipeline, hot-node idle release, and the
discrete-event continuous-batching engine model used for simulated (large)
models. A copy of the JAX package's ``repro/core/instances.py``, unchanged
in behaviour. The DES runs on a virtual clock on the host; no adapter puts
the port's real engine behind this interface.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum

from repro_torch.serving.costmodel import (InstanceCost,
                                           expected_spec_tokens,
                                           restore_tokens)
from repro_torch.serving.scheduler import class_rank

_inst_ids = itertools.count(1)


@dataclass
class SimRequest:
    """Control-plane view of a request: token counts + QoS tags."""
    request_id: str
    prompt_tokens: int
    max_tokens: int
    user: str = "anonymous"
    qos: str = "interactive"          # workload class (interactive | batch)
    priority: int = 0                 # intra-class (lower = more urgent)
    deadline: float | None = None     # absolute TTFT deadline (loop time)
    stream: bool = False              # emit per-sync token deltas
    resume_tokens: int = 0            # failover resume: tokens ALREADY
    #                                   generated elsewhere — the engine
    #                                   restores (prompt+resume) via chunked
    #                                   prefill and continues from there
    no_handoff: bool = False          # pin to the current engine: a prefill-
    #                                   role engine decodes it locally instead
    #                                   of handing off (fallback after a
    #                                   failed/unroutable handoff)
    first_token_at: float | None = None   # stamped by the first dispatch; a
    #                                   resumed/handed-off request's TTFT is
    #                                   its ORIGINAL first token, not the
    #                                   resume point


class InstanceState(str, Enum):
    PENDING = "queued"       # batch job waiting for nodes
    LOADING = "starting"     # nodes acquired, weights loading
    HOT = "running"          # serving
    RELEASED = "released"
    FAILED = "failed"


class SimEngine:
    """DES model of a continuous-batching engine: per engine-step, every
    running sequence gains one token; newly admitted sequences add their
    prefill time to the step they join. Mirrors the real engine's
    iteration-level scheduling.

    Three data-plane toggles mirror ``repro_torch.serving.engine.EngineConfig``:

    * ``prefix_cache_hit_rate`` — steady-state fraction of each prompt found
      in the hot instance's KV prefix cache (shared system prompts / few-shot
      templates); those tokens cost no prefill compute. Models a WARM
      instance — a cold instance's first prompts would miss, which this
      first-order model ignores.
    * ``chunked_prefill_budget`` — max prompt tokens ingested per engine
      step (None = whole prompts in the admission step). Sequences produce
      their first token only once their prefill budget has been consumed,
      and each step's duration charges only that step's chunk — bounding
      inter-token latency for running sequences, exactly like the real
      engine.
    * ``decode_steps_per_sync`` — the fused multi-step decode loop: each
      scheduled step covers K tokens per running sequence, charged
      ``K * decode_step_time(steps_per_sync=K)`` (the host-sync overhead
      amortized over K), and tokens surface in bursts of K at sync time —
      so throughput rises while tail inter-token latency quantizes to the
      sync period, matching the JAX package's
      ``benchmarks/decode_loop.py``. Falls back to
      K=1 whenever a prefill is in flight or new sequences were admitted,
      mirroring the real engine's composition-change rule.
    * ``spec_tokens`` / ``spec_accept_rate`` / ``draft_cost`` — speculative
      decoding: each steady-state round charges
      ``spec_round_time(batch, draft_cost, k)`` (k+1 fused draft steps plus
      ONE batched verify forward) and every running sequence gains
      ``expected_spec_tokens(accept_rate, k)`` tokens, matching
      the JAX package's ``benchmarks/spec_decode.py``. Rounds fall back to
      plain decode steps
      whenever a prefill is in flight or the composition changed — the same
      rule as the real engine's ``_decode_spec`` fallback.
    * ``scheduling_policy`` / ``enable_preemption`` / ``restore_hit_rate``
      — the QoS mirror of ``repro_torch.serving.scheduler``: 'priority' admits
      interactive before batch (then intra-class priority, then arrival),
      'edf' admits by earliest TTFT deadline; with preemption on, a
      blocked more-urgent arrival evicts the most recently admitted
      less-urgent running sequence, whose re-admission charges a restore
      prefill of ``restore_tokens(held, restore_hit_rate)`` tokens — the
      recompute-via-prefix-cache cost term of the real engine's restore.
    """

    def __init__(self, loop, cost: InstanceCost, max_slots: int = 48,
                 on_idle=None, on_busy=None,
                 prefix_cache_hit_rate: float = 0.0,
                 chunked_prefill_budget: int | None = None,
                 decode_steps_per_sync: int = 1,
                 spec_tokens: int = 0, spec_accept_rate: float = 0.8,
                 draft_cost: InstanceCost | None = None,
                 scheduling_policy: str = "fcfs",
                 enable_preemption: bool = False,
                 restore_hit_rate: float = 1.0,
                 role: str = "unified", on_handoff=None):
        self.loop = loop
        self.cost = cost
        self.max_slots = max_slots
        self.on_idle = on_idle
        self.on_busy = on_busy
        if role not in ("unified", "prefill-heavy", "decode-heavy"):
            raise ValueError(f"unknown engine role {role!r}")
        # disaggregated serving: a prefill-heavy engine ingests prompts,
        # emits each sequence's FIRST token, then offers the sequence to
        # ``on_handoff(sreq, produced) -> bool`` — True moves it to a
        # decode-role engine (via the resume/restore machinery), False
        # keeps decoding here (unified fallback)
        self.role = role
        self.on_handoff = on_handoff
        self.prefix_cache_hit_rate = prefix_cache_hit_rate
        self.chunked_prefill_budget = chunked_prefill_budget
        self.decode_steps_per_sync = max(int(decode_steps_per_sync), 1)
        self.spec_tokens = max(int(spec_tokens), 0)
        self.spec_accept_rate = spec_accept_rate
        self.draft_cost = draft_cost
        if self.spec_tokens and draft_cost is None:
            raise ValueError("spec_tokens > 0 requires draft_cost")
        if scheduling_policy not in ("fcfs", "priority", "edf"):
            raise ValueError(f"unknown scheduling policy "
                             f"{scheduling_policy!r}")
        self.scheduling_policy = scheduling_policy
        self.enable_preemption = enable_preemption
        self.restore_hit_rate = restore_hit_rate
        # (sreq, on_first_token, on_done, on_delta) waiting entries
        self.queue: list[tuple] = []
        self.running: list[dict] = []
        # preempted victims awaiting re-admission (restore): running-dicts
        # with their produced-token state preserved
        self._preempted_q: list[dict] = []
        self._seq = itertools.count()
        self._seq_of: dict[str, int] = {}     # request_id -> arrival order
        self._step_ev = None
        self._step_k = 1
        self._composition_changed = False
        self.total_output_tokens = 0
        self.total_finished = 0
        self.total_cached_tokens = 0
        self.total_restore_cached_tokens = 0
        self.total_resumed_tokens = 0
        self.total_preemptions = 0
        self.total_aborted = 0
        self.total_handoffs = 0
        self.halted = False

    # -- load signals ----------------------------------------------------------
    @property
    def load(self) -> int:
        return len(self.queue) + len(self._preempted_q) + len(self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.queue) + len(self._preempted_q)

    def saturated(self) -> bool:
        return len(self.running) >= self.max_slots and self.queue_depth > 0

    # -- ops -----------------------------------------------------------------------
    def submit(self, sreq: SimRequest, on_first_token, on_done,
               on_delta=None):
        """``on_delta(n_tokens, t, offset)`` — optional per-sync token
        stream: fired every engine step this request emits tokens in, with
        ``offset`` the stream position of the burst's first token (the DES
        mirror of the real engine's StreamDelta channel)."""
        if self.halted:
            raise RuntimeError("engine halted")
        self._seq_of[sreq.request_id] = next(self._seq)
        self.queue.append((sreq, on_first_token, on_done, on_delta))
        if self.on_busy:
            self.on_busy()
        self._kick()

    def abort(self, request_id: str) -> bool:
        """Drop a request wherever it lives (queued, preempted, running);
        its slot frees at once. Client disconnects and losing hedges land
        here via the endpoint's pre-registered 'abort' function."""
        for i, e in enumerate(self.queue):
            if e[0].request_id == request_id:
                del self.queue[i]
                self._seq_of.pop(request_id, None)
                self.total_aborted += 1
                return True
        for i, e in enumerate(self._preempted_q):
            if e["req"].request_id == request_id:
                del self._preempted_q[i]
                self.total_aborted += 1
                return True
        for i, e in enumerate(self.running):
            if e["req"].request_id == request_id:
                del self.running[i]
                self._composition_changed = True
                self.total_aborted += 1
                return True
        return False

    def take_queued(self) -> list[tuple]:
        """Remove and return every waiting fresh entry (work stealing).
        The robbed engine's ``_seq_of`` must shrink with its queue — the
        arrival order is re-issued by the receiving engine's ``submit`` —
        or the map leaks one entry per stolen request forever."""
        entries = list(self.queue)
        self.queue.clear()
        for e in entries:
            self._seq_of.pop(e[0].request_id, None)
        return entries

    def halt(self) -> list[SimRequest]:
        """Stop serving (failure/release); returns in-flight requests for
        requeue.  Requests that already produced tokens are stamped with
        ``resume_tokens`` so the next engine RESUMES them (restore prefill
        of prompt+generated) instead of regenerating from scratch — the
        stream offsets stay contiguous and the client never re-receives a
        token."""
        self.halted = True
        if self._step_ev:
            self.loop.cancel(self._step_ev)
            self._step_ev = None
        for r in self.running + self._preempted_q:
            r["req"].resume_tokens = r["produced"]
        inflight = [r["req"] for r in self.running] + \
            [r["req"] for r in self._preempted_q] + \
            [q[0] for q in self.queue]
        self.running.clear()
        self._preempted_q.clear()
        self.queue.clear()
        self._seq_of.clear()
        return inflight

    # -- QoS scheduling mirror --------------------------------------------------
    def _key(self, sreq: SimRequest, seq: int) -> tuple:
        """Admission order: FCFS = arrival; priority = (class, priority,
        arrival); EDF = (deadline, arrival) with None sorting last."""
        if self.scheduling_policy == "priority":
            return (class_rank(sreq.qos), sreq.priority, seq)
        if self.scheduling_policy == "edf":
            d = float("inf") if sreq.deadline is None else sreq.deadline
            return (d, seq)
        return (seq,)

    def _urgency(self, sreq: SimRequest) -> float:
        if self.scheduling_policy == "priority":
            return class_rank(sreq.qos)
        if self.scheduling_policy == "edf":
            return float("inf") if sreq.deadline is None else sreq.deadline
        return 0.0

    def _next_waiting(self):
        """(key, kind, idx) of the most urgent waiting entry, or None.
        Preempted victims keep their original arrival order, so they sort
        ahead of later arrivals of the same class."""
        best = None
        for idx, e in enumerate(self._preempted_q):
            k = self._key(e["req"], e["seq"])
            if best is None or k < best[0]:
                best = (k, "restore", idx)
        for idx, (sreq, *_cbs) in enumerate(self.queue):
            k = self._key(sreq, self._seq_of[sreq.request_id])
            if best is None or k < best[0]:
                best = (k, "fresh", idx)
        return best

    def _pick_victim(self, head: SimRequest) -> dict | None:
        """Most recently admitted running entry strictly less urgent than
        ``head`` (mid-prefill entries are not preemptible — restoring them
        would just repeat the same prefill)."""
        for e in reversed(self.running):
            if e["prefill_left"] > 0:
                continue
            if self._urgency(e["req"]) > self._urgency(head):
                return e
        return None

    def _admit_one(self) -> bool:
        pick = self._next_waiting()
        if pick is None:
            return False
        if len(self.running) >= self.max_slots:
            if not (self.enable_preemption
                    and self.scheduling_policy != "fcfs"):
                return False
            head = (self._preempted_q[pick[2]]["req"] if pick[1] == "restore"
                    else self.queue[pick[2]][0])
            victim = self._pick_victim(head)
            if victim is None:
                return False
            self.running.remove(victim)
            victim["preemptions"] = victim.get("preemptions", 0) + 1
            self.total_preemptions += 1
            self._composition_changed = True
            self._preempted_q.append(victim)
            pick = self._next_waiting()      # indices moved; re-resolve
        _key, kind, idx = pick
        if kind == "restore":
            e = self._preempted_q.pop(idx)
            # restore = recompute-via-prefix-cache prefill of the tokens
            # the cache does not cover (costmodel.restore_tokens). Tracked
            # apart from the prompt prefix-cache discount — the real
            # engine's RequestMetrics keeps cached_prompt_tokens and
            # restore_cached_tokens distinct too
            held = e["req"].prompt_tokens + e["produced"]
            restore = restore_tokens(held, self.restore_hit_rate)
            e["prefill_left"] = restore
            self.total_restore_cached_tokens += max(held - restore, 0)
            e["restore_cached"] = e.get("restore_cached", 0) \
                + max(held - restore, 0)
            self.running.append(e)
        elif self.queue[idx][0].resume_tokens > 0:
            sreq, on_first, on_done, on_delta = self.queue.pop(idx)
            # failover resume: this request already streamed tokens on an
            # engine that died. Restore = chunked-prefill recompute of
            # (prompt + generated) through the prefix cache — the
            # cross-engine analogue of a preemption restore — then decode
            # continues from resume_tokens, so delta offsets stay
            # contiguous with what the client already holds.
            resume = min(sreq.resume_tokens, sreq.max_tokens)
            held = sreq.prompt_tokens + resume
            restore = restore_tokens(held, self.restore_hit_rate)
            cached = max(held - restore, 0)
            self.total_restore_cached_tokens += cached
            self.total_resumed_tokens += resume
            self.running.append({"req": sreq,
                                 "produced": resume,
                                 "prefill_left": restore, "chunks": 0,
                                 "cached": 0, "restore_cached": cached,
                                 "resumed": resume,
                                 "seq": self._seq_of.pop(sreq.request_id),
                                 "on_first": on_first, "on_done": on_done,
                                 "on_delta": on_delta})
        else:
            sreq, on_first, on_done, on_delta = self.queue.pop(idx)
            # warm-cache discount: matched prefix tokens cost no compute;
            # at least one token is always recomputed (its logits seed
            # sampling), mirroring PagedKVCache.allocate_with_prefix
            eff = max(int(round(sreq.prompt_tokens
                                * (1.0 - self.prefix_cache_hit_rate))), 1)
            self.total_cached_tokens += sreq.prompt_tokens - eff
            self.running.append({"req": sreq, "produced": 0,
                                 "prefill_left": eff, "chunks": 0,
                                 "cached": sreq.prompt_tokens - eff,
                                 # the arrival order moves into the entry;
                                 # _seq_of must not grow with engine age
                                 "seq": self._seq_of.pop(sreq.request_id),
                                 "on_first": on_first, "on_done": on_done,
                                 "on_delta": on_delta})
        return True

    # -- internals ------------------------------------------------------------
    def _kick(self):
        if self._step_ev is None and not self.halted:
            self._schedule_step()

    def _schedule_step(self):
        admitted = False
        while self._admit_one():
            admitted = True
        if not self.running:
            self._step_ev = None
            if self.on_idle:
                self.on_idle()
            return
        # consume prompt tokens FIFO up to the chunk budget (all of them
        # when chunking is off); only their compute lands in this step
        prefill_cost = 0.0
        left = self.chunked_prefill_budget or float("inf")
        for r in self.running:
            if left <= 0:
                break
            if r["prefill_left"] > 0:
                take = min(r["prefill_left"], left)
                r["prefill_left"] -= take
                r["chunks"] += 1
                left -= take
                prefill_cost += self.cost.prefill_time(take)
        # multi-step decode: K tokens per sync unless a prefill is in
        # flight or the batch composition changed — admissions AND the
        # finishes/frees of the previous sync, which dirty the real
        # engine's slot state (same fallback rule as
        # ContinuousBatchingEngine._decode_fused)
        steady = not (admitted or self._composition_changed
                      or prefill_cost > 0
                      or any(r["prefill_left"] > 0 for r in self.running))
        self._composition_changed = False
        batch = len(self.running)
        ctx = sum(r["req"].prompt_tokens + r["produced"]
                  for r in self.running) / batch
        ctx = max(int(ctx), 1)
        if self.spec_tokens and steady:
            # speculative round: k+1 draft steps + one verify forward per
            # expected_spec_tokens(a, k) tokens per sequence
            self._step_k = max(int(round(expected_spec_tokens(
                self.spec_accept_rate, self.spec_tokens))), 1)
            dt = self.cost.spec_round_time(batch, self.draft_cost,
                                           self.spec_tokens, ctx=ctx) \
                + prefill_cost
        else:
            k = self.decode_steps_per_sync if steady else 1
            self._step_k = k
            dt = k * self.cost.decode_step_time(batch, ctx=ctx,
                                                steps_per_sync=k) \
                + prefill_cost
        self._step_ev = self.loop.call_after(dt, self._finish_step)

    def _finish_step(self):
        self._step_ev = None
        if self.halted:
            return
        now = self.loop.now()
        still = []
        for r in self.running:
            if r["prefill_left"] > 0:           # still ingesting its prompt
                still.append(r)
                continue
            first = r["produced"] == 0
            # a sequence reaching max_tokens mid-sync stops there, like the
            # device loop's done mask freezing the slot
            take = min(self._step_k, r["req"].max_tokens - r["produced"])
            r["produced"] += take
            self.total_output_tokens += take
            if first and r["on_first"]:
                r["on_first"](now)
            if take and r.get("on_delta"):
                r["on_delta"](take, now, r["produced"] - take)
            if r["produced"] >= r["req"].max_tokens:
                self.total_finished += 1
                self._composition_changed = True   # next sync runs K=1
                if r["on_done"]:
                    r["on_done"]({"request_id": r["req"].request_id,
                                  "output_tokens": r["produced"],
                                  "cached_prompt_tokens": r["cached"],
                                  "restore_cached_tokens":
                                      r.get("restore_cached", 0),
                                  "resumed_tokens": r.get("resumed", 0),
                                  "preemptions": r.get("preemptions", 0),
                                  "prefill_chunks": r["chunks"],
                                  "finish_time": now})
                continue
            # disaggregated prefill role: the prompt is ingested and the
            # first token(s) just streamed — offer the sequence to a
            # decode-role engine. resume_tokens carries the produced count
            # so the receiver restores (prompt + produced) through the
            # prefix-cache machinery and the stream continues contiguously.
            if (self.role == "prefill-heavy" and self.on_handoff is not None
                    and not r["req"].no_handoff):
                r["req"].resume_tokens = r["produced"]
                if self.on_handoff(r["req"], r["produced"]):
                    self.total_handoffs += 1
                    self._composition_changed = True
                    continue           # the entry leaves; no on_done here
            still.append(r)
        self.running = still
        self._schedule_step()


class ModelInstance:
    """One serving job: scheduler job -> weight load -> hot engine."""

    def __init__(self, loop, model_name: str, cost: InstanceCost,
                 scheduler, *, num_nodes: int = 1, max_slots: int = 48,
                 idle_timeout: float = 7200.0, on_released=None,
                 on_failed=None, on_hot=None, walltime: float | None = None,
                 result_cpu: float = 0.0,
                 prefix_cache_hit_rate: float = 0.0,
                 chunked_prefill_budget: int | None = None,
                 decode_steps_per_sync: int = 1,
                 spec_tokens: int = 0, spec_accept_rate: float = 0.8,
                 draft_cost: InstanceCost | None = None,
                 scheduling_policy: str = "fcfs",
                 enable_preemption: bool = False,
                 restore_hit_rate: float = 1.0,
                 role: str = "unified", on_handoff=None):
        self.loop = loop
        self.model_name = model_name
        self.cost = cost
        self.scheduler = scheduler
        self.idle_timeout = idle_timeout
        # per-instance Globus-worker result serialization (packaging +
        # upload happen on ONE endpoint worker process per instance)
        self.result_cpu = result_cpu
        self._result_busy = 0
        self._result_q: list = []
        self.instance_id = f"{model_name}#{next(_inst_ids)}"
        self.state = InstanceState.PENDING
        self.on_released = on_released
        self.on_failed = on_failed
        self.on_hot = on_hot
        self._pending: list[tuple[SimRequest, object, object]] = []
        self._idle_ev = None
        self.engine = SimEngine(loop, cost, max_slots=max_slots,
                                on_idle=self._went_idle,
                                on_busy=self._went_busy,
                                prefix_cache_hit_rate=prefix_cache_hit_rate,
                                chunked_prefill_budget=chunked_prefill_budget,
                                decode_steps_per_sync=decode_steps_per_sync,
                                spec_tokens=spec_tokens,
                                spec_accept_rate=spec_accept_rate,
                                draft_cost=draft_cost,
                                scheduling_policy=scheduling_policy,
                                enable_preemption=enable_preemption,
                                restore_hit_rate=restore_hit_rate,
                                role=role, on_handoff=on_handoff)
        self.role = role
        self.hot_since = None
        # when this HOT instance last drained to zero work (None while
        # busy/cold) — the pool-level keepalive scale-in reads this
        self.idle_since = None
        self.created = loop.now()
        self.job = scheduler.submit(num_nodes, on_start=self._nodes_ready,
                                    on_end=self._job_ended,
                                    walltime=walltime)

    # -- lifecycle ------------------------------------------------------------
    def _nodes_ready(self, job):
        if self.state != InstanceState.PENDING:
            return
        self.state = InstanceState.LOADING
        self.loop.call_after(self.cost.load_time(), self._loaded)

    def _loaded(self):
        if self.state != InstanceState.LOADING:
            return
        self.state = InstanceState.HOT
        self.hot_since = self.loop.now()
        for sreq, on_first, on_done, on_delta in self._pending:
            self.engine.submit(sreq, on_first, on_done, on_delta)
        self._pending.clear()
        if self.on_hot:
            self.on_hot(self)
        if self.engine.load == 0:
            self._went_idle()

    def _job_ended(self, job):
        if self.state in (InstanceState.RELEASED, InstanceState.FAILED):
            return
        failed = job.state.value == "failed"
        self.fail() if failed else self.release()

    # -- serving -----------------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self.state in (InstanceState.PENDING, InstanceState.LOADING,
                              InstanceState.HOT)

    @property
    def load(self) -> int:
        return len(self._pending) + self.engine.load

    def submit(self, sreq: SimRequest, on_first_token, on_done,
               on_delta=None):
        assert self.alive, f"submit to {self.state} instance"
        self._cancel_idle()
        if self.result_cpu > 0:
            on_done = self._serialized(on_done)
        if self.state == InstanceState.HOT:
            self.engine.submit(sreq, on_first_token, on_done, on_delta)
        else:
            self._pending.append((sreq, on_first_token, on_done, on_delta))

    def abort(self, request_id: str) -> bool:
        """Abort a request parked on or running in this instance."""
        for i, p in enumerate(self._pending):
            if p[0].request_id == request_id:
                del self._pending[i]
                return True
        if self.engine.abort(request_id):
            if self.engine.load == 0 and not self._pending:
                self._went_idle()
            return True
        return False

    def _serialized(self, on_done):
        """Charge ``result_cpu`` per completion on the instance's single
        endpoint-worker thread before the result leaves the node."""
        def wrapped(result):
            self._result_q.append((on_done, result))
            self._pump_results()
        return wrapped

    def _pump_results(self):
        if self._result_busy or not self._result_q:
            return
        self._result_busy = 1
        on_done, result = self._result_q.pop(0)

        def _fire():
            self._result_busy = 0
            on_done(result)
            self._pump_results()

        self.loop.call_after(self.result_cpu, _fire)

    # -- hot-node management (paper §3.2.2) ----------------------------------------
    def _went_idle(self):
        if self.state != InstanceState.HOT:
            return
        if self.idle_since is None:
            self.idle_since = self.loop.now()
        if self.idle_timeout is not None:
            self._cancel_idle()
            # daemon: housekeeping must not keep the event loop "busy"
            self._idle_ev = self.loop.call_after(self.idle_timeout,
                                                 self._idle_release,
                                                 daemon=True)

    def _went_busy(self):
        self.idle_since = None
        self._cancel_idle()

    def _cancel_idle(self):
        if self._idle_ev is not None:
            self.loop.cancel(self._idle_ev)
            self._idle_ev = None

    def _idle_release(self):
        if self.state == InstanceState.HOT and self.engine.load == 0:
            self.release()

    # -- teardown ------------------------------------------------------------------
    def release(self):
        if not self.alive:
            return
        self.state = InstanceState.RELEASED
        self._cancel_idle()
        inflight = self.engine.halt() + [p[0] for p in self._pending]
        self._pending.clear()
        self.scheduler.release(self.job)
        if self.on_released:
            self.on_released(self, inflight)

    def fail(self):
        if not self.alive:
            return
        self.state = InstanceState.FAILED
        self._cancel_idle()
        inflight = self.engine.halt() + [p[0] for p in self._pending]
        self._pending.clear()
        # a dead serving process must not pin its nodes: release the batch
        # job (no-op when the job itself died — release() ignores ended/
        # failed jobs) so replacement capacity can start
        self.scheduler.release(self.job)
        if self.on_failed:
            self.on_failed(self, inflight)
