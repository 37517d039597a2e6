"""The Inference Gateway: async OpenAI-compatible front end (paper §3.1).

Responsibilities reproduced from the paper: identity validation (with the
Optimization-2 introspection cache), request validation, per-user rate
limiting, response caching, conversion of API requests into compute tasks,
activity logging, and the /jobs status endpoint.

The public surface is the typed /v1 contract (``repro_torch.api``): ``submit``
accepts a typed request (or a legacy dict, parsed through the same
schemas), resolves its future with a typed response carrying OpenAI
``usage`` accounting, and rejects with the stable ``APIError`` taxonomy —
``rate_limit_error`` denials compute a retry-after from the token bucket,
capacity exhaustion is ``overloaded``, unknown models are
``model_not_found``.

Streaming: a ``stream=true`` request takes an ``on_delta`` callback and
receives incremental ``StreamDelta`` frames as the engine emits tokens —
so first-token and inter-token latency are OBSERVED AT THE GATEWAY
(recorded per-request in ``MetricsLog``), not inferred from completion
records. ``cancel()`` propagates a client disconnect to the endpoint's
pre-registered abort function, freeing the engine slot. Hedged duplicates
race to the FIRST TOKEN: the loser is cancelled through the same abort
path instead of running to completion.

The worker pool models the Gunicorn/Uvicorn capacity. Three paper
optimizations are config toggles so benchmarks can ablate them:
  * Optimization 1 — ``poll_interval=0`` uses futures; ``>0`` polls task
    status on a timer (adds up to one interval of latency per request).
  * Optimization 2 — ``auth_cache`` on the CachingAuthClient +
    ``connection_cache`` on the ComputeClient.
  * Optimization 3 — ``blocking_workers=False`` (async Django-Ninja style:
    workers release after dispatch) vs ``True`` (sync Django-REST style:
    a worker is held for the request's whole lifetime; the paper's original
    deployment processed only nine requests at a time).

A copy of the JAX package's ``repro/core/gateway.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import itertools
import random
from collections import deque
from dataclasses import dataclass, replace

from repro_torch.api import schemas
from repro_torch.api.errors import (APIError, AuthenticationError,
                                    DegradedError, InvalidRequestError,
                                    ModelNotFoundError, OverloadedError,
                                    RateLimitError, RequestCancelled,
                                    UpstreamTimeoutError)
from repro_torch.core.auth import AccessPolicy, AuthError, CachingAuthClient
from repro_torch.core.clock import Future
from repro_torch.core.compute import ComputeError
from repro_torch.core.metrics import MetricsLog
from repro_torch.core.resilience import (BreakerPolicy, BrownoutController,
                                         BrownoutPolicy, CircuitBreaker,
                                         RetryBudget, RetryPolicy)

VALID_ENDPOINTS = schemas.VALID_ENDPOINTS

# legacy alias: pre-/v1 callers caught GatewayError; every error the
# gateway raises now is an APIError subclass
GatewayError = APIError


@dataclass
class GatewayConfig:
    workers: int = 64                  # gunicorn workers x threads
    request_cpu_time: float = 0.002    # per-request gateway handling cost (s)
    blocking_workers: bool = False     # Optimization 3 toggle (True = sync)
    poll_interval: float = 0.0         # Optimization 1 toggle (>0 = polling)
    rate_limit_per_user: float = float("inf")   # req/s token bucket
    rate_burst: float = 100.0
    response_cache_size: int = 4096
    max_queue: int = 1_000_000
    # straggler mitigation (off by default): if a dispatched request has not
    # completed after this many seconds, hedge a duplicate to a DIFFERENT
    # endpoint; the duplicates race to the FIRST TOKEN and the loser is
    # cancelled (its engine slot frees instead of decoding to completion)
    hedge_after: float | None = None
    # resilience layer (all off by default; see repro_torch.core.resilience):
    # retry = per-request retry budget with backoff+jitter and per-attempt
    # timeouts; a failed/timed-out attempt re-dispatches elsewhere, and a
    # stream that already delivered tokens RESUMES (resume_tokens) instead
    # of regenerating. breaker = per-endpoint circuit breakers feeding
    # select_endpoint exclusions. brownout = graceful degradation ladder.
    retry: RetryPolicy | None = None
    breaker: BreakerPolicy | None = None
    brownout: BrownoutPolicy | None = None
    retry_budget_ratio: float = 0.2    # global deposit per admitted request
    retry_seed: int = 0                # jitter rng (deterministic replays)


class RateLimiter:
    """Per-user token bucket."""

    def __init__(self, loop, rate: float, burst: float):
        self.loop = loop
        self.rate = rate
        self.burst = burst
        self._state: dict[str, tuple[float, float]] = {}   # user -> (tokens, t)
        self.denied = 0

    def acquire(self, user: str) -> tuple[bool, float]:
        """(allowed, retry_after): on denial, retry_after is the time until
        the bucket accrues the next whole request token. A zero rate is a
        valid drain-only config (burst requests, then nothing): once the
        burst is spent the bucket never refills, so retry_after is inf."""
        if self.rate == float("inf"):
            return True, 0.0
        now = self.loop.now()
        tokens, t = self._state.get(user, (self.burst, now))
        tokens = min(self.burst, tokens + (now - t) * self.rate)
        if tokens < 1.0:
            self._state[user] = (tokens, now)
            self.denied += 1
            wait = float("inf") if self.rate <= 0.0 \
                else (1.0 - tokens) / self.rate
            return False, wait
        self._state[user] = (tokens - 1.0, now)
        return True, 0.0

    def allow(self, user: str) -> bool:
        return self.acquire(user)[0]


class ResponseCache:
    """LRU cache for deterministic (temperature=0) repeated requests.

    Keys REQUIRE a content identity (an explicit ``prompt_hash`` or a hash
    of materialized token ids): two different prompts that merely share a
    token count must never share an entry, so count-only DES requests are
    uncacheable by construction."""

    def __init__(self, size: int):
        self.size = size
        self._d: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(req):
        """``req`` is a typed /v1 request."""
        if req.temperature != 0.0:
            return None
        content = req.content_hash
        if content is None:          # no content identity -> not cacheable
            return None
        return (req.model, req.endpoint, content, req.max_tokens)

    def get(self, key):
        if key is None:
            return None
        v = self._d.get(key)
        if v is not None:
            self.hits += 1
            self._d.pop(key)
            self._d[key] = v          # move to back
        else:
            self.misses += 1
        return v

    def put(self, key, value):
        if key is None:
            return
        if len(self._d) >= self.size:
            self._d.pop(next(iter(self._d)))
        self._d[key] = value


class WorkerPool:
    """M/D/c model of the API server's worker capacity."""

    def __init__(self, loop, workers: int, service_time: float,
                 max_queue: int = 1_000_000):
        self.loop = loop
        self.workers = workers
        self.service_time = service_time
        self.max_queue = max_queue
        self.busy = 0
        self.queue: deque = deque()
        self.rejected = 0
        self.max_depth = 0

    def submit(self, fn) -> bool:
        """fn(release) runs when a worker is free; fn MUST eventually call
        release() to return the worker."""
        if len(self.queue) >= self.max_queue:
            self.rejected += 1
            return False
        self.queue.append(fn)
        self.max_depth = max(self.max_depth, len(self.queue))
        self._pump()
        return True

    def _pump(self):
        while self.busy < self.workers and self.queue:
            fn = self.queue.popleft()
            self.busy += 1

            def _run(fn=fn):
                done = {"v": False}

                def release():
                    if not done["v"]:
                        done["v"] = True
                        self.busy -= 1
                        self._pump()

                fn(release)

            # the worker spends service_time of CPU before the handler logic
            self.loop.call_after(self.service_time, _run)


class InferenceGateway:
    def __init__(self, loop, auth: CachingAuthClient, router, compute,
                 policy: AccessPolicy | None = None,
                 config: GatewayConfig | None = None,
                 metrics: MetricsLog | None = None,
                 batch=None):
        self.loop = loop
        self.auth = auth
        self.router = router
        self.compute = compute
        self.policy = policy or AccessPolicy()
        self.config = config or GatewayConfig()
        self.metrics = metrics or MetricsLog()
        self.batch = batch                 # BatchService for /v1/batches
        self.pool = WorkerPool(loop, self.config.workers,
                               self.config.request_cpu_time,
                               self.config.max_queue)
        self.rate = RateLimiter(loop, self.config.rate_limit_per_user,
                                self.config.rate_burst)
        self.cache = ResponseCache(self.config.response_cache_size)
        self._ids = itertools.count(1)
        self.hedges = 0
        # request_id -> in-flight race state (for cancel / hedging)
        self._active: dict[str, dict] = {}
        # resilience layer (see repro_torch.core.resilience)
        self.retry_policy = self.config.retry
        self.retry_budget = (RetryBudget(self.config.retry_budget_ratio)
                             if self.config.retry is not None else None)
        self.breakers: dict[str, CircuitBreaker] = {}
        self._retry_rng = random.Random(self.config.retry_seed)
        self.brownout = (BrownoutController(self.config.brownout)
                         if self.config.brownout is not None else None)
        if self.brownout is not None:
            self._brownout_tick()

    # -- resilience helpers ------------------------------------------------------
    def _breaker(self, endpoint_id: str) -> CircuitBreaker | None:
        if self.config.breaker is None:
            return None
        b = self.breakers.get(endpoint_id)
        if b is None:
            b = self.breakers[endpoint_id] = \
                CircuitBreaker(endpoint_id, self.config.breaker)
        return b

    def _breaker_failure(self, endpoint_id: str, timeout: bool = False):
        b = self._breaker(endpoint_id)
        if b is None:
            return
        before = b.opens
        b.on_failure(self.loop.now(), timeout=timeout)
        if b.opens > before:
            self.metrics.on_breaker_open()

    def _breaker_success(self, endpoint_id: str):
        b = self._breaker(endpoint_id)
        if b is not None:
            b.on_success(self.loop.now())

    def _broken_endpoints(self) -> set:
        """Endpoints currently excluded by their breaker (side-effect-free:
        half-open probe slots are only consumed at dispatch)."""
        now = self.loop.now()
        return {e for e, b in self.breakers.items() if b.blocked(now)}

    def _brownout_tick(self):
        """Evaluate the degradation ladder: pressure is the max of the
        worker-pool backlog fraction and the unhealthy-capacity fraction."""
        backlog = len(self.pool.queue) / max(self.pool.workers * 4, 1)
        healthy = 1.0
        hf = getattr(self.router, "healthy_fraction", None)
        if callable(hf):
            healthy = hf()
        pressure = max(min(backlog, 1.0), 1.0 - healthy)
        self.brownout.observe(pressure, self.loop.now())
        self.loop.call_after(self.brownout.policy.eval_interval,
                             self._brownout_tick, daemon=True)

    # -- public API -------------------------------------------------------------
    def submit(self, token: str, request, on_delta=None) -> Future:
        """Serve one /v1 request. ``request`` is a typed
        ``repro_torch.api.schemas`` request (or a legacy dict, parsed through the
        same schemas — unknown endpoints / malformed fields reject with
        ``invalid_request_error``). With ``stream=true``, ``on_delta``
        receives incremental ``StreamDelta`` frames; the returned future
        still resolves with the full typed response."""
        fut = Future()
        try:
            if isinstance(request, dict):
                request = schemas.parse_request(request)
            else:
                request = request.validate()
        except APIError as e:
            self.metrics.on_reject(e.code)
            fut.set_error(e)
            return fut
        rid = request.request_id or f"gw-{next(self._ids)}"
        request = replace(request, request_id=rid)
        arrival = self.loop.now()

        registry = getattr(self.router, "registry", None)
        if registry is not None and request.model not in registry:
            self.metrics.on_reject(ModelNotFoundError.code)
            fut.set_error(ModelNotFoundError(
                f"model {request.model!r} is not configured on any "
                "endpoint"))
            return fut

        if self.brownout is not None:
            # graceful degradation, declared steps: batch QoS is shed first
            # (level >= 1); at the deepest level admission tightens so work
            # cannot queue into a system that has lost its capacity
            if self.brownout.shed_batch() and request.qos == "batch":
                self.brownout.shed += 1
                self.metrics.on_brownout_shed()
                self.metrics.on_reject(DegradedError.code)
                fut.set_error(DegradedError(
                    f"gateway degraded (level {self.brownout.level}): "
                    "batch requests are shed until capacity recovers",
                    retry_after=self.brownout.policy.dwell))
                return fut
            cap = self.brownout.admission_cap(self.config.workers)
            if cap is not None and len(self.pool.queue) >= cap:
                self.brownout.shed += 1
                self.metrics.on_brownout_shed()
                self.metrics.on_reject(DegradedError.code)
                fut.set_error(DegradedError(
                    f"gateway degraded (level {self.brownout.level}): "
                    f"admission tightened to {cap} waiting requests",
                    retry_after=self.brownout.policy.dwell))
                return fut

        def handler(release):
            self._handle(release, token, request, fut, arrival, on_delta)

        if not self.pool.submit(handler):
            self.metrics.on_reject(OverloadedError.code)
            fut.set_error(OverloadedError(
                f"gateway queue full ({self.pool.max_queue} waiting)"))
        return fut

    def cancel(self, request_id: str) -> bool:
        """Client disconnect: abort the in-flight request everywhere it was
        dispatched (engine slots free immediately) and reject its future
        with ``request_cancelled``."""
        state = self._active.pop(request_id, None)
        if state is None or state["done"]:
            return False
        state["done"] = True
        if state.get("timer") is not None:
            self.loop.cancel(state["timer"])
            state["timer"] = None
        for ep, task_rid, _attempt in state["dispatched"]:
            self.compute.cancel(ep, task_rid)
        self.metrics.on_finish(request_id, self.loop.now(), ok=False,
                               error="client disconnected",
                               error_code=RequestCancelled.code)
        state["release"]()
        state["fut"].set_error(RequestCancelled(
            f"request {request_id} cancelled by the client"))
        return True

    # -- request pipeline -------------------------------------------------------
    def _handle(self, release, token, request, fut, arrival, on_delta):
        rid = request.request_id
        state = {"done": False, "winner": None, "dispatched": [],
                 "out_idx": 0, "delivered": 0, "fut": fut,
                 "release": release,
                 # retry layer: the CURRENT attempt number gates every
                 # event/completion callback, so a superseded attempt's
                 # stragglers can never corrupt the client stream
                 "attempt": 0, "tried": set(), "timer": None}

        def finish_ok(resp, cached=False):
            self._active.pop(rid, None)
            resp.cached = cached
            if cached:
                resp.id = rid          # the hit serves THIS request
            if cached and request.stream and on_delta is not None:
                # a response-cache hit streams back as one burst frame +
                # the finish frame (no engine was involved)
                now = self.loop.now()
                on_delta(schemas.StreamDelta(
                    id=rid, index=0, n_tokens=resp.usage.completion_tokens,
                    created=now))
                on_delta(schemas.StreamDelta(
                    id=rid, index=1, n_tokens=0, created=now, finished=True,
                    finish_reason="length"))
            self.metrics.on_finish(
                rid, self.loop.now(), resp.usage.completion_tokens,
                cached=cached,
                cached_prompt_tokens=resp.usage.cached_tokens,
                prefill_chunks=resp.prefill_chunks)
            if self.config.blocking_workers:
                release()
            fut.set_result(resp)

        def finish_err(err):
            if not isinstance(err, APIError):
                # taxonomy guarantee: a raw upstream failure (e.g. a
                # ComputeError from a crashed endpoint, retries exhausted)
                # still surfaces as a typed /v1 error
                err = APIError(f"upstream failure: {err}")
            self._active.pop(rid, None)
            code = err.code if isinstance(err, APIError) else ""
            self.metrics.on_finish(rid, self.loop.now(), ok=False,
                                   error=str(err), error_code=code)
            release()
            fut.set_error(err)

        def after_auth(ident):
            if isinstance(ident, AuthError):
                return finish_err(AuthenticationError(str(ident)))
            model = request.model
            self.metrics.on_arrival(rid, ident.user, model, arrival,
                                    request.prompt_token_count)
            if not self.policy.allowed(ident, model):
                return finish_err(AuthenticationError(
                    f"user {ident.user} lacks access to {model}"))
            allowed, wait = self.rate.acquire(ident.user)
            if not allowed:
                self.metrics.on_reject(RateLimitError.code)
                return finish_err(RateLimitError(
                    f"user {ident.user} exceeded "
                    f"{self.rate.rate:g} req/s", retry_after=wait))
            req = replace(request, user=ident.user)
            ck = self.cache.key(req)
            hit = self.cache.get(ck)
            if hit is not None:
                return finish_ok(hit.copy(), cached=True)
            self._active[rid] = state
            fn = "embed" if req.endpoint == "embeddings" else "generate"
            # the live back-channel carries first-token events whenever a
            # race needs deciding (hedging) or the client asked to stream
            want_events = req.stream or bool(self.config.hedge_after)
            policy = self.retry_policy
            if policy is not None:
                self.retry_budget.on_request()

            def _clear_timer():
                if state["timer"] is not None:
                    self.loop.cancel(state["timer"])
                    state["timer"] = None

            def _arm_timer(ep, task_rid, attempt, timeout):
                """Per-attempt progress bound: before the first token it is
                the (deadline-derived) TTFT timeout; once frames flow it is
                re-armed per frame with the stall bound. Firing kills the
                attempt and retries — the only recovery path from a SILENT
                endpoint death. (For non-streaming requests without a live
                channel the bound covers the whole attempt.)"""
                _clear_timer()
                if timeout is None:
                    return

                def fire():
                    state["timer"] = None
                    if state["done"] or attempt != state["attempt"]:
                        return
                    self.metrics.on_timeout(rid)
                    self._breaker_failure(ep, timeout=True)
                    self.compute.cancel(ep, task_rid)
                    retry_or_fail(UpstreamTimeoutError(
                        f"attempt {attempt + 1} on {ep} made no progress "
                        f"within {timeout:g}s"))

                state["timer"] = self.loop.call_after(timeout, fire)

            def _rearm_stall(ep, task_rid, attempt):
                if policy is None:
                    return
                _arm_timer(ep, task_rid, attempt, policy.stall_timeout)

            def _effective_attempts() -> int:
                if policy is None:
                    return 1
                n = policy.max_attempts
                if self.brownout is not None:
                    n = self.brownout.effective_attempts(n)
                return n

            def retry_or_fail(err):
                """A dispatch attempt failed (task error, timeout, or no
                placeable endpoint): back off and re-dispatch if the
                per-request allowance AND the global retry budget permit,
                else surface the error."""
                if state["done"]:
                    return
                if policy is not None \
                        and state["attempt"] + 1 < _effective_attempts() \
                        and self.retry_budget.try_withdraw():
                    old = state["attempt"]
                    for ep_, trid_, att_ in state["dispatched"]:
                        if att_ == old:     # stale racers (e.g. a hedge)
                            self.compute.cancel(ep_, trid_)
                    resumed = state["delivered"]
                    state["attempt"] = attempt = old + 1
                    state["winner"] = None
                    _clear_timer()
                    self.metrics.on_retry(rid, resumed_tokens=resumed)
                    delay = policy.backoff(attempt - 1, self._retry_rng)

                    def _go():
                        if state["done"] or attempt != state["attempt"]:
                            return
                        dispatch(exclude=frozenset(state["tried"])
                                 | self._broken_endpoints(),
                                 attempt=attempt)

                    self.loop.call_after(delay, _go)
                    return
                state["done"] = True
                _clear_timer()
                finish_err(err)

            def on_first_event(ep, attempt):
                def cb(task_rid, t_engine):
                    if state["done"] or attempt != state["attempt"]:
                        return
                    if state["winner"] is None:
                        state["winner"] = ep
                        self.metrics.on_first_token(rid, self.loop.now())
                        self._cancel_losers(state, ep)
                    # losing racers are cancelled; their events are dropped
                    if ep == state["winner"]:
                        _rearm_stall(ep, task_rid, attempt)
                return cb

            def on_delta_event(ep, attempt):
                def cb(frame):
                    if attempt != state["attempt"]:
                        return              # a superseded attempt's frame
                    if state["done"] and not frame.finished:
                        return
                    if state["winner"] is None:
                        state["winner"] = ep
                        self._cancel_losers(state, ep)
                    if ep != state["winner"]:
                        return
                    if not frame.finished:
                        _rearm_stall(ep, frame.id, attempt)
                    if frame.n_tokens:
                        # dedupe by stream offset: a fault-tolerance
                        # requeue restarts generation from token 0, so
                        # drop (or trim) re-emitted positions — the
                        # client never sees a token twice
                        end = frame.offset + frame.n_tokens
                        fresh = end - max(frame.offset, state["delivered"])
                        if fresh <= 0:
                            return
                        if fresh < frame.n_tokens:
                            toks = frame.tokens[-fresh:] \
                                if frame.tokens is not None else None
                            frame = replace(frame, n_tokens=fresh,
                                            tokens=toks,
                                            offset=end - fresh)
                        state["delivered"] = end
                    # renumber: the client sees ONE contiguous stream even
                    # if endpoint-side restarts re-emitted frames
                    frame = replace(frame, id=rid, index=state["out_idx"])
                    state["out_idx"] += 1
                    if not frame.finished:
                        self.metrics.on_delta(rid, self.loop.now(),
                                              frame.n_tokens)
                    if on_delta is not None:
                        on_delta(frame)
                return cb

            def dispatch(exclude=(), attempt=0, hedge=False):
                try:
                    ep = self.router.select_endpoint(model, exclude=exclude,
                                                     qos=req.qos)
                except Exception as e:           # noqa: BLE001
                    # FederationError already carries the 'overloaded' code
                    if hedge:
                        return None          # a failed hedge changes nothing
                    retry_or_fail(e)         # capacity may come back
                    return None
                b = self._breaker(ep)
                if b is not None:
                    b.allow(self.loop.now())   # consume the half-open probe
                self.metrics.on_dispatch(rid, ep, self.loop.now())
                task_rid = rid if not (hedge or attempt) else \
                    (f"{rid}~hedge" if hedge else f"{rid}~r{attempt}")
                wire_req = req if task_rid == rid \
                    else replace(req, request_id=task_rid)
                if attempt and state["delivered"]:
                    # mid-stream failover: the new engine RESUMES from what
                    # the client already holds (restore via prefix cache)
                    # instead of regenerating — the client sees a gap,
                    # never a duplicated or lost token
                    wire_req = replace(wire_req,
                                       resume_tokens=state["delivered"])
                task = self.compute.submit(
                    ep, fn, schemas.to_wire(wire_req),
                    on_first_token=(on_first_event(ep, attempt)
                                    if want_events else None),
                    on_delta=(on_delta_event(ep, attempt) if req.stream
                              else None))
                state["dispatched"].append((ep, task_rid, attempt))
                state["tried"].add(ep)
                if policy is not None and not hedge:
                    _arm_timer(ep, task_rid, attempt,
                               policy.timeout_for(attempt, self.loop.now(),
                                                  req.deadline))

                def on_task(f):
                    if state["done"]:
                        return              # a racer already finished
                    if attempt != state["attempt"]:
                        return              # attempt superseded by a retry
                    if state["winner"] is not None \
                            and ep != state["winner"]:
                        return              # the loser was cancelled
                    if f.error is not None:
                        if isinstance(f.error, RequestCancelled):
                            return          # our own abort (timeout/hedge)
                        self._breaker_failure(ep)
                        if isinstance(f.error, (ComputeError,
                                                OverloadedError)):
                            return retry_or_fail(f.error)
                        state["done"] = True
                        _clear_timer()
                        return finish_err(f.error)
                    state["done"] = True
                    _clear_timer()
                    self._breaker_success(ep)
                    res = f.result()
                    if not req.stream and not want_events:
                        # no live channel: fall back to the engine-side
                        # first-token stamp off the completion record
                        self.metrics.on_first_token(
                            rid, res.get("first_token_time", self.loop.now()))
                    resp = schemas.response_from_result(req, res, arrival)
                    if state["attempt"] == 0:
                        # resumed responses are stitched across engines;
                        # only clean single-attempt outputs enter the cache
                        self.cache.put(ck, resp)
                    finish_ok(resp)

                if self.config.poll_interval > 0:
                    self._poll(task, on_task)   # pre-Optimization-1 mode
                else:
                    task.add_done_callback(on_task)
                return ep

            first_ep = dispatch(exclude=self._broken_endpoints())
            # Optimization 3: async workers release after dispatch
            if not self.config.blocking_workers:
                release()
            if first_ep is not None and self.config.hedge_after:
                def maybe_hedge():
                    if state["done"] or state["winner"] is not None \
                            or state["attempt"] != 0:
                        return
                    if self.brownout is not None \
                            and self.brownout.suppress_hedges():
                        return              # degraded: hedges are shed
                    self.hedges += 1
                    dispatch(exclude=(first_ep,), hedge=True)

                self.loop.call_after(self.config.hedge_after,
                                     maybe_hedge, daemon=True)

        self.auth.validate(token, after_auth)

    def _cancel_losers(self, state: dict, winner_ep):
        """First-token-wins: abort every dispatched duplicate of the CURRENT
        attempt that is not the winner, freeing its engine slot mid-decode.
        (Prior attempts' tasks were already cancelled when they retried.)"""
        for ep, task_rid, attempt in state["dispatched"]:
            if attempt == state["attempt"] and ep != winner_ep:
                self.compute.cancel(ep, task_rid)
                self.metrics.on_hedge_cancelled()

    # -- /v1/batches ------------------------------------------------------------
    def create_batch(self, token: str, request) -> Future:
        """Submit an OpenAI-shaped batch (``BatchRequest`` or a list of
        item dicts); resolves with the initial ``BatchStatus``."""
        fut = Future()
        if self.batch is None:
            fut.set_error(InvalidRequestError(
                "this gateway has no batch service attached"))
            return fut
        try:
            if isinstance(request, dict):
                request = schemas.BatchRequest.from_dict(request)
            elif isinstance(request, list):
                request = schemas.BatchRequest(
                    items=[schemas.BatchItem.from_dict(it)
                           if isinstance(it, dict) else it
                           for it in request])
            request = request.validate()
            if not request.items:
                raise InvalidRequestError("empty batch", param="items")
        except APIError as e:
            self.metrics.on_reject(e.code)
            fut.set_error(e)
            return fut

        def after_auth(ident):
            if isinstance(ident, AuthError):
                return fut.set_error(AuthenticationError(str(ident)))
            model = request.model
            if not self.policy.allowed(ident, model):
                return fut.set_error(AuthenticationError(
                    f"user {ident.user} lacks access to {model}"))
            registry = getattr(self.router, "registry", None)
            if registry is not None and model not in registry:
                return fut.set_error(ModelNotFoundError(
                    f"model {model!r} is not configured on any endpoint"))
            job = self.batch.create(request, user=ident.user)
            fut.set_result(job.batch_status())

        self.auth.validate(token, after_auth)
        return fut

    def batch_status(self, batch_id: str):
        """Poll /v1/batches/{id}."""
        if self.batch is None:
            raise InvalidRequestError("no batch service attached")
        return self.batch.status(batch_id)

    def batch_results(self, batch_id: str) -> list:
        """Retrieve per-request results/errors of a finished batch."""
        if self.batch is None:
            raise InvalidRequestError("no batch service attached")
        return self.batch.results(batch_id)

    # -- status -----------------------------------------------------------------
    def jobs_status(self) -> dict:
        """The /jobs endpoint (paper §4.3): per-model instance states from
        the federation plus the gateway's own admission-control counters."""
        out = self.router.jobs_status()
        out["_gateway"] = {
            "workers_busy": self.pool.busy,
            "queue_depth": len(self.pool.queue),
            "max_depth": self.pool.max_depth,
            "rejected_queue_full": self.pool.rejected,
            "rate_limited": self.rate.denied,
            "rejections": dict(self.metrics.rejections),
            "hedges": self.hedges,
            "hedges_cancelled": self.metrics.hedges_cancelled,
            # resilience layer
            "degradation_level": (self.brownout.level
                                  if self.brownout is not None else 0),
            "retries": self.metrics.retries,
            "timeouts": self.metrics.timeouts,
            "failovers_resumed": self.metrics.failovers_resumed,
            "resumed_tokens": self.metrics.resumed_tokens,
            "breaker_opens": self.metrics.breaker_opens,
        }
        if self.brownout is not None:
            out["_gateway"]["degradation"] = self.brownout.snapshot()
        if self.breakers:
            now = self.loop.now()
            out["_gateway"]["breakers"] = {
                e: b.snapshot(now) for e, b in self.breakers.items()}
        if self.retry_budget is not None:
            out["_gateway"]["retry_budget"] = round(
                self.retry_budget.balance, 3)
        return out

    # -- helpers ---------------------------------------------------------------
    def _poll(self, task: Future, cb):
        """Pre-Optimization-1 result retrieval: check task status every
        ``poll_interval`` seconds."""
        def tick():
            if task.done():
                cb(task)
            else:
                self.loop.call_after(self.config.poll_interval, tick)
        self.loop.call_after(self.config.poll_interval, tick)
