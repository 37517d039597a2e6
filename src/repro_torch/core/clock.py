"""Virtual clock + discrete-event loop driving the FIRST control plane.

Every control-plane component (gateway, scheduler, endpoints, instances,
autoscaler, failure injector) schedules callbacks on one EventLoop, so whole
workload traces run deterministically and instantly on CPU, while the same
components can be driven by a real clock in live deployments.

A copy of the JAX package's ``repro/core/clock.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field


class VirtualClock:
    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def _advance_to(self, t: float):
        assert t >= self._t - 1e-12, f"time went backwards: {t} < {self._t}"
        self._t = max(self._t, t)


class RealClock:
    def now(self) -> float:
        return time.monotonic()


@dataclass(order=True)
class _Event:
    t: float
    seq: int
    fn: object = field(compare=False)
    args: tuple = field(compare=False, default=())
    cancelled: bool = field(compare=False, default=False)
    daemon: bool = field(compare=False, default=False)


class EventLoop:
    def __init__(self, clock: VirtualClock | None = None):
        self.clock = clock or VirtualClock()
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self._non_daemon = 0

    def now(self) -> float:
        return self.clock.now()

    def call_at(self, t: float, fn, *args, daemon: bool = False) -> _Event:
        ev = _Event(t=max(t, self.now()), seq=next(self._seq), fn=fn,
                    args=args, daemon=daemon)
        heapq.heappush(self._heap, ev)
        if not daemon:
            self._non_daemon += 1
        return ev

    def call_after(self, dt: float, fn, *args, daemon: bool = False) -> _Event:
        return self.call_at(self.now() + dt, fn, *args, daemon=daemon)

    def cancel(self, ev: _Event):
        if ev is not None and not ev.cancelled:
            ev.cancelled = True
            if not ev.daemon:
                self._non_daemon -= 1

    def _pop_run(self, ev: _Event):
        if not ev.daemon:
            self._non_daemon -= 1
        self.clock._advance_to(ev.t)
        ev.fn(*ev.args)

    # -- running ------------------------------------------------------------
    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0].t <= t_end:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._pop_run(ev)
        self.clock._advance_to(t_end)

    def run_until_idle(self, max_t: float = float("inf")) -> None:
        """Run until only daemon events (periodic monitors) remain."""
        while self._heap and self._non_daemon > 0:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if ev.t > max_t:
                heapq.heappush(self._heap, ev)
                break
            self._pop_run(ev)

    @property
    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)


class Future:
    """DES-friendly future (paper Optimization 1: results propagate through
    callbacks the moment they complete — no polling)."""

    __slots__ = ("_done", "_result", "_error", "_callbacks")

    def __init__(self):
        self._done = False
        self._result = None
        self._error = None
        self._callbacks = []

    def done(self) -> bool:
        return self._done

    def set_result(self, value):
        assert not self._done, "future already resolved"
        self._done = True
        self._result = value
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()

    def set_error(self, err):
        assert not self._done
        self._done = True
        self._error = err
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()

    def result(self):
        if not self._done:
            raise RuntimeError("future not resolved")
        if self._error is not None:
            raise self._error if isinstance(self._error, Exception) \
                else RuntimeError(self._error)
        return self._result

    @property
    def error(self):
        return self._error

    def add_done_callback(self, cb):
        if self._done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def chain(self, other: "Future"):
        """Resolve ``other`` with this future's outcome."""
        def _cb(f):
            if f._error is not None:
                other.set_error(f._error)
            else:
                other.set_result(f._result)
        self.add_done_callback(_cb)
