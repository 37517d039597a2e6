"""Spans and counters of the serving engine's host work: one recorder a
process, :data:`RECORDER`.

The recorder is on while :meth:`Recorder.enable` holds or a
``torch.profiler`` session runs. ``ContinuousBatchingEngine.step`` asks
once, at its top (:meth:`Recorder.refresh`); every other site reads the
``on`` attribute, so a step costs a few attribute reads while it is off.
Turning on after being off clears the records: the last session's stay
readable after it ends. Nothing is exported; run under ``torch.profiler``
(or call ``RECORDER.enable()``), then read ``RECORDER.spans`` and
``RECORDER.counters``.

Times are ``time.perf_counter_ns`` (the clock is injectable for tests):
the clock the benchmark harness reads and maps its device trace onto, so
program spans, harness steps and device activities share one time axis.

Spans (``Span``: name, t0, t1, parent index, request id, attrs):

* ``step``, the root of every other: one ``engine.step()``; attrs the
  sequences by state when it began (running, prefilling, waiting);
* ``admit`` (rid): the policy's pop and the backend's ``start_prefill``
  (prefix match, page allocation), or a preempted sequence's restore;
* ``prefill.chunk`` (rid; start, tokens); ``first_token`` (rid);
* ``decode.prep`` (page headroom, copy-on-write, block-table refresh,
  state upload), ``decode.issue`` (the K-step loop
  issued, up to the device-to-host copy; K asked, K run, live slots,
  max_slots), ``decode.sync`` (that copy), ``decode.emit`` (the host's
  per-slot loop of deltas, finishes and slot releases);
* ``spec.round``: the speculative path's decode (a draft-and-verify
  round, or the fused call it falls back to without page headroom);
* ``sync`` (site, n, h2d): every blocking host-device transfer (a copy
  to or from pageable memory waits for the stream), ``n`` of them;
* ``queue`` (rid), no parent: from ``add_request`` (or a preemption's
  requeue) to admission.

Counters: ``decode_calls``; ``decode_k1.prefill`` and
``decode_k1.batch_changed`` (a fused call dropped to K = 1 because a
prefill was in flight, else because the batch changed); ``syncs.<site>``
(blocking transfers); ``decode_graph.replay`` (fused decode steps replayed
as a CUDA graph), ``decode_graph.eager`` (fused decode steps issued op by
op, on every other path) and ``decode_graph.capture`` (graphs captured);
``decode_rows.stepped`` and ``decode_rows.live`` (the slot backend's fused
calls: rows computed, every slot each iteration, and the rows among them
that produced a token); ``shared_block.apps`` (applications of the
hybrid's shared or tied attention block, in prefill and decode).
"""
from __future__ import annotations

import time

import torch

SPAN_CAP = 500_000


class Span:
    """One recorded interval; a context manager that closes it."""

    __slots__ = ("name", "t0", "t1", "parent", "rid", "attrs", "_rec")

    def __init__(self, rec, name, t0, parent, rid, attrs):
        self.name, self.t0, self.t1 = name, t0, None
        self.parent, self.rid, self.attrs, self._rec = parent, rid, attrs, rec

    def set(self, rid=None, **attrs) -> None:
        """Attributes known only once the span has run."""
        if rid is not None:
            self.rid = rid
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._rec.clock()
        self._rec._open.pop()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.t0}, {self.t1}, parent="
                f"{self.parent}, rid={self.rid!r}, {self.attrs})")


class _Off:
    """What a site gets while the recorder is off: does nothing."""

    __slots__ = ()

    def set(self, rid=None, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


OFF = _Off()


class Recorder:
    def __init__(self, clock=time.perf_counter_ns, cap: int = SPAN_CAP):
        self.clock = clock
        self.cap = cap
        self.enabled = False
        self.on = False
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self._open: list[int] = []      # indices of the open spans

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def refresh(self) -> bool:
        """On while enabled or while a ``torch.profiler`` session runs;
        clears the records when it turns on. Returns ``on``."""
        on = self.enabled or torch.autograd.profiler._is_profiler_enabled
        if on and not self.on:
            self.clear()
        self.on = on
        return on

    def clear(self) -> None:
        self.spans, self.counters, self.dropped = [], {}, 0
        self._open = []

    def span(self, name: str, rid=None, **attrs):
        """Opens a span under the innermost open one; use it in ``with``."""
        if not self.on:
            return OFF
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return OFF
        s = Span(self, name, self.clock(),
                 self._open[-1] if self._open else None, rid, attrs)
        self._open.append(len(self.spans))
        self.spans.append(s)
        return s

    def add(self, name: str, t0: int, rid=None, **attrs) -> None:
        """A closed span from ``t0`` to now, with no parent (``queue``)."""
        if not self.on:
            return
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return
        s = Span(self, name, t0, None, rid, attrs)
        s.t1 = self.clock()
        self.spans.append(s)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def sync(self, site: str, n: int = 1, h2d: bool = True):
        """A ``sync`` span around ``n`` blocking transfers, host to device
        unless ``h2d`` is False."""
        if not self.on:
            return OFF
        self.count("syncs." + site, n)
        return self.span("sync", site=site, n=n, h2d=h2d)


RECORDER = Recorder()
