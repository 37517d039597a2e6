"""Gateway-side resilience primitives: retry policy with backoff + jitter,
a Finagle-style global retry budget, per-endpoint circuit breakers, and the
graceful-brownout controller.

These are pure state machines over the virtual clock — the gateway owns
the orchestration (``InferenceGateway._handle``), this module owns the
decisions. Everything here is deterministic given the seed, so the chaos
gates in the JAX package's ``benchmarks/chaos_soak.py`` can assert exact
accounting.

A copy of the JAX package's ``repro/core/resilience.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Per-request retry configuration (attempt 0 is the initial dispatch).

    ``attempt_timeout`` bounds each attempt's time-to-first-token; when the
    request carries an absolute TTFT ``deadline`` the per-attempt timeout is
    derived from it instead (remaining time split across remaining
    attempts), so the budget tightens as attempts burn.  ``stall_timeout``
    bounds the gap between stream frames once tokens are flowing — the only
    way to notice a *silent* mid-stream death.
    """
    max_attempts: int = 3              # total attempts, initial + retries
    base_backoff: float = 0.5          # seconds; doubles per retry
    max_backoff: float = 8.0
    attempt_timeout: float | None = 30.0   # TTFT bound per attempt
    stall_timeout: float | None = None     # inter-frame bound mid-stream
    min_attempt_timeout: float = 0.25  # floor when a deadline shrinks it

    def backoff(self, retry_index: int, rng: random.Random) -> float:
        """Exponential backoff with FULL jitter (uniform over [0, cap]):
        decorrelated waves of retries instead of synchronized stampedes."""
        cap = min(self.max_backoff,
                  self.base_backoff * (2.0 ** max(retry_index, 0)))
        return rng.uniform(0.0, cap)

    def timeout_for(self, attempt: int, now: float,
                    deadline: float | None) -> float | None:
        """Per-attempt TTFT timeout. With a deadline, split what is left of
        it across the attempts that remain; otherwise the flat bound."""
        if deadline is not None:
            left = deadline - now
            remaining = max(self.max_attempts - attempt, 1)
            t = left / remaining
            if self.attempt_timeout is not None:
                t = min(t, self.attempt_timeout)
            return max(t, self.min_attempt_timeout)
        return self.attempt_timeout


class RetryBudget:
    """Global (gateway-wide) retry budget: every initial request deposits
    ``ratio`` tokens, every retry withdraws one.  Bounds cluster-wide retry
    amplification to ~``ratio`` of offered load when everything is failing —
    the failure mode where naive per-request retries multiply an outage.
    ``floor`` seeds the balance so low-traffic periods can still retry."""

    def __init__(self, ratio: float = 0.2, floor: float = 5.0,
                 cap: float = 100.0):
        self.ratio = ratio
        self.floor = floor
        self.cap = cap
        self.balance = float(floor)
        self.deposits = 0
        self.withdrawals = 0
        self.denied = 0

    def on_request(self) -> None:
        self.deposits += 1
        self.balance = min(self.cap, self.balance + self.ratio)

    def try_withdraw(self) -> bool:
        if self.balance >= 1.0:
            self.balance -= 1.0
            self.withdrawals += 1
            return True
        self.denied += 1
        return False


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

@dataclass
class BreakerPolicy:
    fail_threshold: int = 3            # consecutive failures to trip
    timeout_rate: float = 0.5          # or: timeout fraction over the window
    window: float = 60.0               # seconds of samples for the rate trip
    min_samples: int = 4               # rate trip needs this many samples
    cooldown: float = 10.0             # open duration before half-open probe
    max_cooldown: float = 120.0        # escalation cap on repeated re-trips


class CircuitBreaker:
    """Per-endpoint breaker: closed -> open -> half-open -> closed.

    * trips OPEN on ``fail_threshold`` consecutive failures, or when the
      timeout fraction over the sliding window exceeds ``timeout_rate``;
    * after ``cooldown`` it lets ONE probe through (half-open); a probe
      success closes it, a probe failure re-opens with the cooldown
      doubled (capped at ``max_cooldown``);
    * ``blocked(now)`` is the router-exclusion view: it never consumes the
      half-open probe, so computing exclusions has no side effects.
    """

    def __init__(self, endpoint_id: str, policy: BreakerPolicy | None = None):
        self.endpoint_id = endpoint_id
        self.policy = policy or BreakerPolicy()
        self.state = "closed"              # closed | open | half_open
        self.open_until = 0.0
        self.opens = 0                     # trip count (for the gates)
        self._consec = 0
        self._cooldown = self.policy.cooldown
        self._probe_inflight = False
        self._events: deque = deque()      # (t, ok, was_timeout)

    # -- observations ------------------------------------------------------
    def _prune(self, now: float) -> None:
        w = self.policy.window
        while self._events and self._events[0][0] < now - w:
            self._events.popleft()

    def on_success(self, now: float) -> None:
        self._events.append((now, True, False))
        self._prune(now)
        self._consec = 0
        if self.state != "closed":
            self.state = "closed"
            self._probe_inflight = False
            self._cooldown = self.policy.cooldown   # de-escalate on recovery

    def on_failure(self, now: float, timeout: bool = False) -> None:
        self._events.append((now, False, timeout))
        self._prune(now)
        self._consec += 1
        if self.state == "half_open":
            self._probe_inflight = False
            self._cooldown = min(self._cooldown * 2.0,
                                 self.policy.max_cooldown)
            self._trip(now)
            return
        if self.state == "closed" and (
                self._consec >= self.policy.fail_threshold
                or self._timeout_rate_exceeded()):
            self._trip(now)

    def _timeout_rate_exceeded(self) -> bool:
        if len(self._events) < self.policy.min_samples:
            return False
        timeouts = sum(1 for _, _, to in self._events if to)
        return timeouts / len(self._events) > self.policy.timeout_rate

    def _trip(self, now: float) -> None:
        self.state = "open"
        self.open_until = now + self._cooldown
        self.opens += 1

    # -- queries -----------------------------------------------------------
    def allow(self, now: float) -> bool:
        """May a dispatch go to this endpoint right now?  Transitions
        open -> half-open when the cooldown has elapsed and consumes the
        single half-open probe slot."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now < self.open_until:
                return False
            self.state = "half_open"
            self._probe_inflight = True
            return True
        # half-open: one probe at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def blocked(self, now: float) -> bool:
        """Side-effect-free exclusion view for the federation router."""
        if self.state == "open":
            return now < self.open_until
        if self.state == "half_open":
            return self._probe_inflight
        return False

    def snapshot(self, now: float) -> dict:
        return {"state": self.state, "opens": self.opens,
                "consecutive_failures": self._consec,
                "cooldown": self._cooldown,
                "open_for": max(self.open_until - now, 0.0)
                if self.state == "open" else 0.0}


# ---------------------------------------------------------------------------
# graceful brownout
# ---------------------------------------------------------------------------

@dataclass
class BrownoutPolicy:
    """Hysteresis thresholds on the gateway's pressure signal (max of the
    worker-pool backlog fraction and the unhealthy-capacity fraction)."""
    enter_pressure: float = 0.7        # step a level UP at/above this
    exit_pressure: float = 0.3         # step a level DOWN at/below this
    dwell: float = 10.0                # min seconds between level changes
    eval_interval: float = 5.0         # how often the gateway evaluates


class BrownoutController:
    """Declared degradation ladder, stepped one level at a time:

      level 0  normal operation
      level 1  shed batch QoS at admission (``degraded`` errors)
      level 2  + suppress hedging, halve the retry allowance
      level 3  + retries off, admission queue tightened

    ``observe(pressure, now)`` drives the ladder with hysteresis (distinct
    enter/exit thresholds + a dwell time) so the level cannot flap on a
    noisy signal.  Every transition is recorded for ``jobs_status()``."""

    MAX_LEVEL = 3
    STEPS = {0: "normal", 1: "shed-batch", 2: "no-hedge/half-retries",
             3: "no-retries/tight-admission"}

    def __init__(self, policy: BrownoutPolicy | None = None):
        self.policy = policy or BrownoutPolicy()
        self.level = 0
        self._last_change = float("-inf")
        self.transitions: list[tuple[float, int, float]] = []  # (t, lvl, p)
        self.shed = 0                       # requests rejected by brownout

    def observe(self, pressure: float, now: float) -> int:
        p = self.policy
        if now - self._last_change >= p.dwell:
            if pressure >= p.enter_pressure and self.level < self.MAX_LEVEL:
                self.level += 1
                self._last_change = now
                self.transitions.append((now, self.level, pressure))
            elif pressure <= p.exit_pressure and self.level > 0:
                self.level -= 1
                self._last_change = now
                self.transitions.append((now, self.level, pressure))
        return self.level

    # -- degradation queries (what each level actually sheds) --------------
    def shed_batch(self) -> bool:
        return self.level >= 1

    def suppress_hedges(self) -> bool:
        return self.level >= 2

    def effective_attempts(self, configured: int) -> int:
        """Retry allowance under degradation: full, halved, then none."""
        if self.level >= 3:
            return 1
        if self.level >= 2:
            return max(1 + (configured - 1) // 2, 1)
        return configured

    def admission_cap(self, workers: int) -> int | None:
        """Tightened gateway queue bound at the deepest level: a request
        that would wait behind more than a few service times is rejected
        up front instead of queueing into a dead system."""
        if self.level >= 3:
            return max(workers * 4, 8)
        return None

    def snapshot(self) -> dict:
        return {"level": self.level, "step": self.STEPS[self.level],
                "shed": self.shed,
                "transitions": len(self.transitions)}
