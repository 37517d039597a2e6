"""Continuous-batching inference engine (the port of the JAX package's
``repro/serving/engine.py``).

One ``step()`` = admit waiting requests into free capacity (prefilling each),
then run batched decode across all running sequences: vLLM-style
iteration-level scheduling. New requests join the running batch between
token steps; finished ones free their slots and pages immediately.

Features, as in the reference:

* **Prefix caching** (``enable_prefix_cache``): prompts whose leading pages
  content-match already-computed pages skip recomputing them.
* **Chunked prefill** (``chunked_prefill_budget`` > 0): each step computes
  at most ``budget`` prompt tokens across the in-flight prefills, then still
  runs the decode batch. A sequence samples its first token (and joins the
  decode batch) once its final chunk completes.
* **Fused decode** (``fused_decode``, default on): decode forward,
  sampling and stop/length checks run on the device; the ``(max_slots, V)``
  logits never come back to the host.
* **Multi-step decode** (``decode_steps_per_sync`` = K > 1): the fused call
  loops K decode steps on the device and the host syncs once per K tokens.
  K falls back to 1 whenever a prefill is in flight or the batch
  composition just changed; outputs are token-identical to the per-step
  path.
* **Speculative decoding** (``spec_tokens`` = k > 0, with a draft model
  of the attention family): per round the draft's fused loop proposes k
  tokens and ONE target forward verifies all k+1 positions, accepting by
  the seeded-sampler exact-match test (``serving/sampler.py``), so greedy
  and seeded top-p streams stay token-identical to non-speculative
  decoding. Both caches truncate to the accepted prefix each round; the
  draft keeps its KV in a mirror backend of the target's kind.
* **Scheduling + preemption** (``scheduling_policy``,
  ``enable_preemption``): FCFS, priority/QoS with per-class token budgets,
  EDF on TTFT deadlines (``serving/scheduler.py``). A preempted sequence
  publishes its pages to the prefix cache, is freed, and is restored by
  recompute-via-prefix-cache -- or, with ``preempt_swap`` (paged backend),
  by a host swap-out/in of its KV -- with the same sampling state, so its
  stream stays token-identical to an uninterrupted run.
* **Control-plane calls**: ``abort``, ``resume_request`` (cross-engine
  failover through the restore path), ``saturated`` (autoscaler signal),
  ``num_running``, ``num_waiting``, ``waiting``.

Two cache backends, as in the reference: ``backend="slots"`` (the
default; every decoder family: dense, moe, vlm, SSM and hybrid; one
contiguous cache row per slot) and ``backend="paged"`` (the attention
families dense, moe and vlm; prefix cache, page pool). The audio family
is an encoder: it is served by ``serving/embedding.py``, not here.

Tensor-parallel serving (``mesh``, a ``(1, N)`` mesh from
``launch/mesh.py``): both backends (and a speculating engine's draft
backend) split the model over the mesh's ``model`` axis; see
``serving/backends.py``. The attention families only: ssm and hybrid
models under a mesh raise ``NotImplementedError`` (ROADMAP Queue 1 item
11b).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.schemas import StreamDelta
from repro_torch.models import LM
from repro_torch.serving.backends import (ATTENTION_FAMILIES, PagedBackend,
                                          PrefillTask, SlotBackend)
from repro_torch.serving.request import (InferenceRequest, RequestMetrics,
                                         RequestOutput)
from repro_torch.serving.sampler import (SEED_MOD, sample_token,
                                         sample_tokens, seed_base)
from repro_torch.serving.scheduler import SchedulingPolicy, make_policy


class _RealClock:
    def now(self) -> float:
        return time.monotonic()


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 512
    backend: str = "slots"            # slots | paged
    page_size: int = 64
    num_pages: int | None = None
    use_kernel: bool = False
    # tensor-parallel serving: a (1, N) launch.mesh.Mesh (make_local_mesh);
    # params, KV and decode kernels split over its "model" axis
    mesh: object | None = None
    max_prefills_per_step: int = 4
    # prompt tokens computed per engine step across all in-flight prefills;
    # 0 disables chunking (whole prompts ingest in their admission step)
    chunked_prefill_budget: int = 0
    # content-addressed KV page reuse across sequences
    enable_prefix_cache: bool = False
    # device-resident decode: decode + sample + stop checks on the device
    # (logits never transferred to host); False = legacy per-step path
    fused_decode: bool = True
    # decode steps per host sync in the fused path (K); falls back to 1
    # while prefills are in flight or the batch composition changed
    decode_steps_per_sync: int = 1
    # speculative decoding: draft tokens proposed per round (0 = off); needs
    # a draft model passed to the engine
    spec_tokens: int = 0
    # 'fcfs', 'priority', 'edf', or a SchedulingPolicy instance
    scheduling_policy: object = "fcfs"
    # allow the policy to evict running lower-urgency sequences
    enable_preemption: bool = False
    # restore preempted sequences from a host KV copy (swap-out/in) instead
    # of recompute-via-prefix-cache (paged backend only)
    preempt_swap: bool = False
    # per-class in-flight token budgets for the priority policy
    qos_token_budgets: dict | None = None


@dataclass
class _Running:
    req: InferenceRequest
    metrics: RequestMetrics
    output_tokens: list = field(default_factory=list)
    delta_idx: int = 0                      # next StreamDelta frame index
    draft_task: PrefillTask | None = None   # speculative draft-cache prefill
    # emitted-stream positions the draft cache holds valid KV for; falls
    # behind cache_len whenever non-speculative rounds run (chunked-prefill
    # interleave, headroom fallback) and is caught up before proposing
    draft_len: int = 0
    # preemption state: True while a restore prefill re-ingests the emitted
    # stream; swap_blob holds the host KV copy on the swap path
    restoring: bool = False
    swap_blob: dict | None = None

    @property
    def last_token(self) -> int:
        return self.output_tokens[-1]

    @property
    def cache_len(self) -> int:
        """KV entries the backend holds for this sequence: every emitted
        token except the last (which is fed, and written, by the next
        step)."""
        return len(self.req.prompt_tokens) + len(self.output_tokens) - 1


class _SlotStates:
    """Slot-indexed decode state, host mirror of the device-resident copy.

    Entries are written on admit (activate) and cleared on free, so the
    per-step hot loop does no host array construction. ``dirty`` means the
    batch composition changed since the device copy was seeded: the next
    fused call re-uploads, and the engine syncs every token (K=1) for that
    step.
    """

    def __init__(self, n: int):
        self.tokens = np.zeros((n,), np.int32)      # last sampled token
        self.n_gen = np.zeros((n,), np.int32)       # tokens generated so far
        self.temps = np.zeros((n,), np.float32)
        self.top_ps = np.ones((n,), np.float32)
        self.seed_base = np.zeros((n,), np.uint32)
        self.stop_tok = np.full((n,), -1, np.int32)  # -1 = no stop token
        self.gen_limit = np.full((n,), np.iinfo(np.int32).max, np.int32)
        self.active = np.zeros((n,), bool)
        self.dirty = True

    def host_state(self) -> dict:
        return {"tokens": self.tokens, "n_gen": self.n_gen,
                "temps": self.temps, "top_ps": self.top_ps,
                "seed_base": self.seed_base, "stop_tok": self.stop_tok,
                "gen_limit": self.gen_limit, "active": self.active}

    def step_seeds(self) -> np.ndarray:
        """PRNG seeds for the next decode step (legacy host path)."""
        s = (self.seed_base + self.n_gen.astype(np.uint32)) % SEED_MOD
        return s.astype(np.int32)


class ContinuousBatchingEngine:
    def __init__(self, model: LM, params, cfg: EngineConfig | None = None,
                 clock=None, *, draft_model: LM | None = None,
                 draft_params=None, device=None):
        """``device``: where the backends keep their caches; default the
        CUDA device (RuntimeError without a card), or under a mesh its lead
        device. ``params`` (and ``draft_params``, for speculative decoding)
        must live there; under a mesh they are split over its shards."""
        self.model = model
        self.cfg = cfg or EngineConfig()
        self.clock = clock or _RealClock()
        mesh = self.cfg.mesh
        if self.cfg.backend == "paged":
            self.backend = PagedBackend(
                model, params, max_slots=self.cfg.max_slots,
                max_len=self.cfg.max_seq_len, page_size=self.cfg.page_size,
                num_pages=self.cfg.num_pages, use_kernel=self.cfg.use_kernel,
                enable_prefix_cache=self.cfg.enable_prefix_cache,
                mesh=mesh, device=device)
        else:
            if self.cfg.enable_prefix_cache:
                raise ValueError("prefix caching requires backend='paged'")
            self.backend = SlotBackend(
                model, params, max_slots=self.cfg.max_slots,
                max_len=self.cfg.max_seq_len, use_kernel=self.cfg.use_kernel,
                mesh=mesh, device=device)
        self.draft_backend = None
        if self.cfg.spec_tokens > 0:
            if draft_model is None:
                raise ValueError("spec_tokens > 0 requires a draft model")
            if not self.cfg.fused_decode:
                raise ValueError("speculative decoding requires fused_decode")
            if not self.backend.supports_spec_decode \
                    or draft_model.cfg.family not in ATTENTION_FAMILIES:
                raise ValueError("speculative decoding requires attention-"
                                 "family target and draft models")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            # the draft keeps its KV beside the target's in a mirror backend
            # of the same kind (no prefix cache: draft pages are private and
            # rolled back every round)
            if self.cfg.backend == "paged":
                self.draft_backend = PagedBackend(
                    draft_model, draft_params, max_slots=self.cfg.max_slots,
                    max_len=self.cfg.max_seq_len,
                    page_size=self.cfg.page_size,
                    num_pages=self.cfg.num_pages,
                    use_kernel=self.cfg.use_kernel, mesh=mesh, device=device)
            else:
                self.draft_backend = SlotBackend(
                    draft_model, draft_params, max_slots=self.cfg.max_slots,
                    max_len=self.cfg.max_seq_len,
                    use_kernel=self.cfg.use_kernel, mesh=mesh, device=device)
        if self.cfg.preempt_swap and self.cfg.backend != "paged":
            raise ValueError("preempt_swap requires backend='paged'")
        kwargs = {}
        if self.cfg.scheduling_policy == "priority" \
                and self.cfg.qos_token_budgets:
            kwargs["token_budgets"] = self.cfg.qos_token_budgets
        self.policy: SchedulingPolicy = make_policy(
            self.cfg.scheduling_policy, **kwargs)
        # request_id -> _Running of preempted sequences awaiting restore
        # (their requests sit in the policy queue like fresh arrivals)
        self._preempted: dict[str, _Running] = {}
        # request_id -> StreamDelta callback for stream=true requests
        self._delta_subs: dict[str, object] = {}
        # request_id -> (_Running, PrefillTask): admitted, prompt not yet
        # fully ingested (only populated when chunked prefill is on)
        self.prefilling: "OrderedDict[str, tuple[_Running, PrefillTask]]" = \
            OrderedDict()
        self.running: dict[str, _Running] = {}
        self.slots = _SlotStates(self.cfg.max_slots)
        self.stats = {"prefill_tokens": 0, "cached_prompt_tokens": 0,
                      "prefill_chunks": 0, "decode_tokens": 0, "steps": 0,
                      "decode_syncs": 0, "finished": 0, "aborted": 0,
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "preemptions": 0, "restores": 0,
                      "restore_cached_tokens": 0, "swap_outs": 0,
                      "swap_ins": 0}

    # -- queue management -------------------------------------------------------
    def add_request(self, req: InferenceRequest, on_delta=None):
        """``on_delta(StreamDelta)``: subscribe to this request's token
        stream -- one frame per engine sync that emitted tokens for it, plus
        a final empty frame carrying ``finish_reason``."""
        m = RequestMetrics(arrival_time=req.arrival_time or self.clock.now(),
                           queued_time=self.clock.now())
        req._metrics = m
        if on_delta is not None:
            self._delta_subs[req.request_id] = on_delta
        self.policy.add(req)

    def resume_request(self, req: InferenceRequest, generated_tokens,
                       on_delta=None):
        """Cross-engine failover resume: admit ``req`` with
        ``generated_tokens`` already produced (and streamed) by an engine
        that died. The preemption-restore path, verbatim: prompt +
        generated is re-ingested by prefill, sampling resumes at ``n_gen =
        len(generated)`` and stream frames continue at that offset, so the
        stitched output is token-identical to an uninterrupted run."""
        if not generated_tokens:
            return self.add_request(req, on_delta)
        m = RequestMetrics(arrival_time=req.arrival_time or self.clock.now(),
                           queued_time=self.clock.now())
        req._metrics = m
        if on_delta is not None:
            self._delta_subs[req.request_id] = on_delta
        run = _Running(req=req, metrics=m,
                       output_tokens=list(generated_tokens))
        self.stats["resumed_tokens"] = \
            self.stats.get("resumed_tokens", 0) + len(generated_tokens)
        self._preempted[req.request_id] = run
        self.policy.add(req)

    def abort(self, request_id: str) -> bool:
        """Drop a request wherever it is (queued, a preempted victim, mid-
        prefill or running), freeing its slot and pages. Returns False if
        the engine does not hold it."""
        self._delta_subs.pop(request_id, None)
        req = self.policy.remove(request_id)
        if req is not None:
            # a queued preempted victim also drops its saved state
            self._preempted.pop(request_id, None)
            self.stats["aborted"] += 1
            return True
        for pool in (self.prefilling, self.running):
            if request_id in pool:
                entry = pool.pop(request_id)
                run = entry[0] if isinstance(entry, tuple) else entry
                self._release_slot(request_id)
                self.policy.on_released(run.req)
                self.stats["aborted"] += 1
                return True
        return False

    def has_work(self) -> bool:
        return bool(len(self.policy) or self.prefilling or self.running)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def num_waiting(self) -> int:
        return len(self.policy)

    @property
    def waiting(self) -> list:
        """Queued requests in the policy's admission order (read-only)."""
        return self.policy.snapshot()

    def saturated(self) -> bool:
        """No free capacity and a queue is forming (autoscaler signal)."""
        if not len(self.policy):
            return False
        head = self.policy.peek()
        if head is None:        # queue non-empty but over a class budget
            return True
        return not self._can_admit(self._admit_len(head))

    def _admit_len(self, req: InferenceRequest) -> int:
        """Tokens the admission prefill must cover: the prompt, or -- for a
        preempted victim being restored -- its whole emitted stream minus
        the last token (whose KV the next decode step writes)."""
        run = self._preempted.get(req.request_id)
        if run is None:
            return len(req.prompt_tokens)
        return len(req.prompt_tokens) + len(run.output_tokens) - 1

    def _can_admit(self, n_prompt: int) -> bool:
        """Admission needs capacity in the target backend and, when
        speculating, in the draft's mirror. With preemption on, an
        admission must also leave enough free pages for the decode appends
        already due this step."""
        if not self.backend.can_admit(n_prompt):
            return False
        if self.cfg.enable_preemption:
            kv = getattr(self.backend, "kv", None)
            if kv is not None and kv.pages_needed(n_prompt + 1) \
                    + self._appends_due() > kv.free_pages:
                return False
        return self.draft_backend is None \
            or self.draft_backend.can_admit(n_prompt)

    def _appends_due(self) -> int:
        """Pages the next decode step must claim for its KV appends (0 for
        the slot backend: its cache is pre-sized)."""
        kv = getattr(self.backend, "kv", None)
        if kv is None:
            return 0
        return sum(1 for sid in self.backend.decoding
                   if kv.pages_needed(kv.length(sid) + 1)
                   > kv.pages_held(sid))

    def cache_stats(self) -> dict:
        """Prefix-cache counters from the backend (empty for the slot
        backend)."""
        return self.backend.cache_stats()

    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        p = self.stats["spec_proposed"]
        return self.stats["spec_accepted"] / p if p else 0.0

    # -- preemption ---------------------------------------------------------------
    def preempt(self, request_id: str) -> bool:
        """Evict a RUNNING sequence: publish its computed pages to the
        prefix cache (or swap its KV to the host), free its slot/pages, and
        requeue it for a later restore. Returns False if the request is not
        currently running."""
        run = self.running.pop(request_id, None)
        if run is None:
            return False
        if self.cfg.preempt_swap:
            run.swap_blob = self.backend.swap_out(request_id)
            self.stats["swap_outs"] += 1
        else:
            # register the victim's full pages in the content index so the
            # restore prefill content-matches them out of the LRU
            stream = run.req.prompt_tokens + run.output_tokens
            self.backend.publish(request_id, stream[:run.cache_len])
        self._release_slot(request_id)
        self.policy.on_released(run.req)
        run.metrics.preemptions += 1
        self.stats["preemptions"] += 1
        self._preempted[request_id] = run
        self.policy.requeue(run.req)
        return True

    def _page_deficit(self) -> int:
        """Pages the next decode step needs beyond what the pool can claim
        (0 for the slot backend: it never runs out mid-decode)."""
        kv = getattr(self.backend, "kv", None)
        if kv is None:
            return 0
        return max(0, self._appends_due() - kv.free_pages)

    def _admissible_ever(self, n_tokens: int) -> bool:
        """Whether an admission of ``n_tokens`` could EVER fit an empty
        engine -- preempting for one that cannot would thrash forever."""
        if n_tokens >= self.cfg.max_seq_len:
            return False
        kv = getattr(self.backend, "kv", None)
        return kv is None or kv.pages_needed(n_tokens + 1) <= kv.num_pages - 1

    def _maybe_preempt(self):
        """Policy-driven eviction, two triggers: the pool cannot cover the
        next decode step's page appends (pressure), or the queue head is
        blocked on capacity while lower-urgency sequences run."""
        if not self.cfg.enable_preemption:
            return
        view = [(rid, run.req, len(run.output_tokens),
                 run.metrics.preemptions)
                for rid, run in self.running.items()]
        deficit = self._page_deficit()
        # pressure needs at least two running sequences: shedding the sole
        # runner frees pages nothing else can use
        while deficit > 0 and len(view) > 1:
            victim = self.policy.select_victim(None, view)
            if victim is None or not self.preempt(victim):
                break
            view = [e for e in view if e[0] != victim]
            deficit = self._page_deficit()
        head = self.policy.peek()
        if head is None:
            return
        n = self._admit_len(head)
        if self._can_admit(n) or not self._admissible_ever(n):
            return
        victim = self.policy.select_victim(head, view)
        if victim is not None:
            self.preempt(victim)

    # -- engine iteration ---------------------------------------------------------
    def step(self) -> list[RequestOutput]:
        self.stats["steps"] += 1
        finished: list[RequestOutput] = []

        # 0) policy-driven eviction (page pressure / blocked urgent head)
        self._maybe_preempt()

        # 1) prefill: whole prompts or up to the chunk budget
        if self.cfg.chunked_prefill_budget > 0:
            self._prefill_chunked(finished)
        else:
            self._prefill_one_shot(finished)

        # 2) batched decode over all running sequences
        if self.running:
            by_slot = {self.backend.slot(rid): run
                       for rid, run in self.running.items()}
            if self.draft_backend is not None and not self.prefilling:
                # speculative round; while chunked prefill interleaves, the
                # plain fused path (K = 1) keeps time-between-tokens bounded
                self._decode_spec(by_slot, finished)
            elif self.cfg.fused_decode and self.backend.supports_fused_decode:
                self._decode_fused(by_slot, finished)
            else:
                self._decode_legacy(by_slot, finished)
        return finished

    def _decode_legacy(self, by_slot: dict, finished: list):
        """Per-token host-driven decode: logits come back to the host and
        are sampled there."""
        st = self.slots
        logits = self.backend.decode_batch(st.tokens)
        toks = sample_tokens(logits, st.temps, st.top_ps,
                             st.step_seeds()).numpy()
        self.stats["decode_syncs"] += 1
        for s, run in by_slot.items():
            tok = int(toks[s])
            run.output_tokens.append(tok)
            st.tokens[s] = tok
            st.n_gen[s] += 1
            self.stats["decode_tokens"] += 1
            self._emit_delta(run, [tok])
            f = self._maybe_finish(run)
            if f:
                finished.append(f)

    def _decode_fused(self, by_slot: dict, finished: list):
        """Device-resident decode: K decode + sample + stop-check steps on
        the device; the host syncs only (K, max_slots) token ids plus
        produced/done vectors."""
        st = self.slots
        K = max(1, self.cfg.decode_steps_per_sync)
        if self.prefilling or st.dirty:
            # prefill in flight or batch composition changed: sync every
            # token so chunked prefill interleaves unchanged
            K = 1
        toks, produced, done = self.backend.fused_decode(
            K, st.host_state() if st.dirty else None)
        st.dirty = False
        self.stats["decode_syncs"] += 1
        for s, run in by_slot.items():
            p = int(produced[s])
            new = [int(toks[j, s]) for j in range(p)]
            run.output_tokens.extend(new)
            st.tokens[s] = run.last_token
            st.n_gen[s] += p
            self.stats["decode_tokens"] += p
            self._emit_delta(run, new)
            f = self._maybe_finish(run)
            if (f is not None) != bool(done[s]):
                raise RuntimeError(
                    f"fused decode divergence for {run.req.request_id}: "
                    f"device done={bool(done[s])}, host finish="
                    f"{f.finish_reason if f else None}")
            if f:
                finished.append(f)

    def _draft_state(self) -> dict:
        """Per-slot state for the draft's proposal loop: the target's
        sampling params and seed fold (a proposal is the token the target
        would sample wherever the logits agree), but no stop token and no
        generation limit: the target's verdict finishes sequences."""
        st = self.slots
        return dict(st.host_state(), stop_tok=np.full_like(st.stop_tok, -1),
                    gen_limit=np.full_like(st.gen_limit,
                                           np.iinfo(np.int32).max))

    def _decode_spec(self, by_slot: dict, finished: list):
        """One draft-and-verify round: the draft's fused loop proposes k
        tokens per slot (k+1 steps, so the last proposal's KV is written
        too), ONE target forward verifies all k+1 positions on the device,
        and both caches truncate to the accepted prefix."""
        st = self.slots
        k = self.cfg.spec_tokens
        lens_by_seq: dict[str, int] = {}
        for run in by_slot.values():
            lens_by_seq[run.req.request_id] = run.cache_len
            # the verify block writes positions cache_len..cache_len+k
            k = min(k, self.cfg.max_seq_len - 1 - run.cache_len)
        k = min(k, self.backend.spec_headroom(max(k, 0)))
        if k < 1:          # no room to speculate (pool tight / seqs at cap)
            return self._decode_fused(by_slot, finished)
        # resync the draft cache: non-speculative rounds advance the emitted
        # stream without it, so it first ingests the tokens it missed ...
        for run in by_slot.values():
            if run.draft_len < run.cache_len:
                stream = run.req.prompt_tokens + run.output_tokens
                self.draft_backend.spec_catch_up(
                    run.req.request_id, stream[:run.cache_len],
                    run.draft_len)
                run.draft_len = run.cache_len
        # ... then truncates to the previous round's accepted prefix and
        # proposes: k+1 fused steps emit k usable proposals and leave the
        # k-th proposal's KV written for the all-accepted case
        self.draft_backend.reset_lens(lens_by_seq)
        draft_toks, _, _ = self.draft_backend.fused_decode(
            k + 1, self._draft_state())
        k_used = min(k, draft_toks.shape[0] - 1)   # draft pool may clamp
        draft = draft_toks[:k_used].T              # (max_slots, k_used)
        out, produced, done = self.backend.spec_verify(
            draft, st.host_state() if st.dirty else None)
        st.dirty = False
        self.stats["decode_syncs"] += 1
        self.stats["spec_rounds"] += 1
        for s, run in by_slot.items():
            p = int(produced[s])
            self.stats["spec_proposed"] += k_used
            self.stats["spec_accepted"] += max(p - 1, 0)
            new = [int(out[j, s]) for j in range(p)]
            run.output_tokens.extend(new)
            self._emit_delta(run, new)
            st.tokens[s] = run.last_token
            st.n_gen[s] += p
            # the proposal loop wrote KV for exactly the accepted prefix
            # (plus rejected rows past the rolled-back length)
            run.draft_len = run.cache_len
            self.stats["decode_tokens"] += p
            f = self._maybe_finish(run)
            if (f is not None) != bool(done[s]):
                raise RuntimeError(
                    f"spec decode divergence for {run.req.request_id}: "
                    f"device done={bool(done[s])}, host finish="
                    f"{f.finish_reason if f else None}")
            if f:
                finished.append(f)

    def run_to_completion(self) -> list[RequestOutput]:
        outs = []
        while self.has_work():
            outs.extend(self.step())
        return outs

    # -- prefill scheduling -------------------------------------------------------
    def _admit(self) -> tuple[_Running, PrefillTask]:
        req = self.policy.pop()
        self.policy.on_admitted(req)
        run = self._preempted.pop(req.request_id, None)
        if run is not None:
            return self._admit_restore(run)
        run = _Running(req=req, metrics=req._metrics)
        task = self.backend.start_prefill(req.request_id, req.prompt_tokens)
        if self.draft_backend is not None:
            # reserve the draft's slot/pages NOW so both backends see the
            # same admit/free order (their slot indices stay equal); the
            # draft's prompt is computed one-shot when the target's prefill
            # completes
            run.draft_task = self.draft_backend.start_prefill(
                req.request_id, req.prompt_tokens)
        run.metrics.cached_prompt_tokens = task.cached_tokens
        self.stats["cached_prompt_tokens"] += task.cached_tokens
        return run, task

    def _admit_restore(self, run: _Running) \
            -> tuple[_Running, PrefillTask | None]:
        """Re-admit a preempted victim. Swap path: upload the saved host KV
        and rejoin the decode batch at once (no task, no recompute).
        Recompute path: a prefill of the emitted stream minus its last
        token, whose leading pages usually content-match what the victim
        published on eviction."""
        rid = run.req.request_id
        run.restoring = True
        hist = (run.req.prompt_tokens + run.output_tokens)[:-1]
        if run.swap_blob is not None:
            self.backend.swap_in(rid, len(hist), run.swap_blob)
            run.swap_blob = None
            self.stats["swap_ins"] += 1
            if self.draft_backend is not None:
                run.draft_task = self.draft_backend.start_prefill(rid, hist)
            self._finish_restore(run)
            return run, None
        task = self.backend.start_prefill(rid, hist)
        if self.draft_backend is not None:
            run.draft_task = self.draft_backend.start_prefill(rid, hist)
        run.metrics.restore_cached_tokens += task.cached_tokens
        self.stats["restore_cached_tokens"] += task.cached_tokens
        return run, task

    def _finish_ingest(self, run: _Running, logits, finished: list):
        """A prompt (or a restore's emitted stream) is fully in the cache:
        rejoin the decode batch -- sampling a first token for fresh
        admissions, resuming the saved stream for restores."""
        if run.restoring:
            self._finish_restore(run)
        else:
            self._finish_prefill(run, logits, finished)

    def _prefill_one_shot(self, finished: list):
        admitted = 0
        while admitted < self.cfg.max_prefills_per_step:
            head = self.policy.peek()
            if head is None or not self._can_admit(self._admit_len(head)):
                break
            run, task = self._admit()
            admitted += 1
            if task is None:                  # swap-in restore: no prefill
                continue
            logits, n = self.backend.prefill_chunk(task, None)
            self._account_chunk(run, n)
            self._finish_ingest(run, logits, finished)

    def _prefill_chunked(self, finished: list):
        budget = self.cfg.chunked_prefill_budget
        left = budget
        # continue in-flight prefills first (FIFO: oldest admission makes
        # progress before new prompts consume budget)
        for rid, (run, task) in list(self.prefilling.items()):
            if left <= 0:
                return
            logits, n = self.backend.prefill_chunk(task, left)
            left -= n
            self._account_chunk(run, n)
            if logits is not None:
                del self.prefilling[rid]
                self._finish_ingest(run, logits, finished)
        admitted = 0
        while left > 0 and admitted < self.cfg.max_prefills_per_step:
            head = self.policy.peek()
            if head is None or not self._can_admit(self._admit_len(head)):
                break
            run, task = self._admit()
            admitted += 1
            if task is None:                  # swap-in restore: no prefill
                continue
            logits, n = self.backend.prefill_chunk(task, left)
            left -= n
            self._account_chunk(run, n)
            if logits is not None:
                self._finish_ingest(run, logits, finished)
            else:
                self.prefilling[run.req.request_id] = (run, task)

    def _account_chunk(self, run: _Running, n_tokens: int):
        self.stats["prefill_tokens"] += n_tokens
        self.stats["prefill_chunks"] += 1
        run.metrics.prefill_chunks += 1

    def _finish_prefill(self, run: _Running, logits, finished: list):
        tok = self._sample_one(run.req, logits, step=0)
        run.output_tokens.append(tok)
        run.metrics.first_token_time = self.clock.now()
        self.stats["decode_tokens"] += 1
        self._emit_delta(run, [tok])
        self.running[run.req.request_id] = run
        f = self._maybe_finish(run)
        if f:
            finished.append(f)
        else:
            if run.draft_task is not None:
                # the draft's KV for the whole prompt in one shot (its
                # logits stay on the device, unused)
                self.draft_backend.prefill_chunk(run.draft_task, None)
                run.draft_len = len(run.req.prompt_tokens)
                self._check_draft_slot(run.req.request_id)
            self._activate_slot(run)

    def _finish_restore(self, run: _Running):
        """A preempted victim's KV is whole again (swap-in or restore
        prefill): rejoin the decode batch with the SAME sampling state
        (``n_gen`` picks up where it left off, so seeds fold identically).
        No token is sampled here."""
        rid = run.req.request_id
        run.restoring = False
        self.running[rid] = run
        self.stats["restores"] += 1
        if run.draft_task is not None:
            self.draft_backend.prefill_chunk(run.draft_task, None)
            run.draft_len = run.cache_len
            self._check_draft_slot(rid)
        self._activate_slot(run)

    def _check_draft_slot(self, request_id: str) -> None:
        if self.draft_backend.slot(request_id) != self.backend.slot(
                request_id):
            raise RuntimeError(f"{request_id}: draft and target slot "
                               f"assignment diverged")

    # -- slot state ---------------------------------------------------------------
    def _activate_slot(self, run: _Running):
        """Seed the slot-indexed decode state when a sequence joins the
        decode batch -- the ONLY place sampling params are materialized."""
        s = self.backend.slot(run.req.request_id)
        sp = run.req.sampling
        st = self.slots
        st.tokens[s] = run.last_token
        st.n_gen[s] = len(run.output_tokens)
        st.temps[s] = sp.temperature
        st.top_ps[s] = sp.top_p
        st.seed_base[s] = seed_base(sp.seed)
        st.stop_tok[s] = -1 if sp.stop_token is None else sp.stop_token
        # one bound covers both finish conditions the device can hit:
        # n_gen >= max_tokens ("length") and prompt+n_gen >= max_seq_len
        st.gen_limit[s] = min(sp.max_tokens,
                              self.cfg.max_seq_len
                              - len(run.req.prompt_tokens))
        st.active[s] = True
        st.dirty = True

    def _release_slot(self, request_id: str):
        s = self.backend.slot(request_id)
        self.slots.active[s] = False
        self.slots.dirty = True
        self.backend.free(request_id)
        if self.draft_backend is not None:
            self.draft_backend.free(request_id)

    # -- helpers ------------------------------------------------------------------
    def _sample_one(self, req, logits, step) -> int:
        """First-token sampling from device-resident prefill logits: only
        the sampled id crosses to the host."""
        sp = req.sampling
        seed = (seed_base(sp.seed) + step) % SEED_MOD
        return int(sample_token(logits, sp.temperature, sp.top_p, seed))

    def _emit_delta(self, run: _Running, toks):
        """Push newly appended tokens to the request's stream subscriber
        (a no-op for unsubscribed requests)."""
        cb = self._delta_subs.get(run.req.request_id)
        if cb is None or not toks:
            return
        frame = StreamDelta(id=run.req.request_id, index=run.delta_idx,
                            tokens=[int(t) for t in toks],
                            n_tokens=len(toks),
                            offset=len(run.output_tokens) - len(toks),
                            created=self.clock.now())
        run.delta_idx += 1
        cb(frame)

    def _maybe_finish(self, run: _Running):
        sp = run.req.sampling
        reason = ""
        if sp.stop_token is not None and run.last_token == sp.stop_token:
            reason = "stop"
        elif len(run.output_tokens) >= sp.max_tokens:
            reason = "length"
        elif len(run.output_tokens) + len(run.req.prompt_tokens) \
                >= self.cfg.max_seq_len:
            reason = "max_seq_len"
        if not reason:
            return None
        cb = self._delta_subs.pop(run.req.request_id, None)
        if cb is not None:                  # final frame: reason, no tokens
            cb(StreamDelta(id=run.req.request_id, index=run.delta_idx,
                           tokens=[], n_tokens=0,
                           offset=len(run.output_tokens),
                           created=self.clock.now(),
                           finished=True, finish_reason=reason))
            run.delta_idx += 1
        run.metrics.finish_time = self.clock.now()
        self._release_slot(run.req.request_id)
        del self.running[run.req.request_id]
        self.policy.on_released(run.req)
        self.stats["finished"] += 1
        return RequestOutput(request_id=run.req.request_id,
                             output_tokens=run.output_tokens, finished=True,
                             finish_reason=reason, metrics=run.metrics)
