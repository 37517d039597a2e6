"""The program's own spans and counters (``repro_torch.serving.tracing``'s
``RECORDER``) in the harness's frame, for the per-layer readers.

The recorder is on while a ``torch.profiler`` session runs, so after a
traced run it holds the engine steps of the traced sub-window and nothing
else. Its times are ``time.perf_counter_ns``, the clock the harness reads
(its ``HostClock``), so one offset brings them into the harness's frame
(seconds after the window opened): the program's ``step`` spans are
matched, in order, to the harness's steps, and each program step opens
just after the harness's, so the offset is the least of (program start -
harness start). A program without the recorder, or records that match no
steps, give None: the reader finds nothing to read.

The device trace comes mapped onto the host clock by one offset, taken at a
marker kernel (``trace.Tracer``). On the card that offset was off by up to
milliseconds, and the two clocks drifted apart by up to two thousandths,
not at a steady rate (``PERF.md``, "The clock"): more than the gaps a
reader of program spans compares. ``remap`` maps it again, between the
program's blocking device-to-host copies.
"""
from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from harness.trace import DeviceTrace

# a copy and the span that waited for it, against the offset predicted:
# well under half the least time between two such copies in the cell (32
# ms), above the drift seen between two of them (2 ms, PERF.md "The clock")
MATCH_S = 5e-3


class PSpan(NamedTuple):
    name: str
    t0: float                 # seconds after the window opened
    t1: float
    parent: int | None        # index into ``Program.spans``
    rid: str | None
    attrs: dict


@dataclass
class Program:
    spans: list               # PSpan, in the order they opened
    counters: dict            # over the traced steps
    offset: float             # program clock (s) - harness frame (s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def ancestors(self, s: PSpan):
        """Indices of the spans that enclose ``s``, innermost first."""
        while s.parent is not None:
            yield s.parent
            s = self.spans[s.parent]


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from repro_torch.serving.tracing import RECORDER
    except ImportError:
        return None
    return RECORDER


def align(steps, starts_ns) -> float | None:
    """Seconds to subtract from a program time (``perf_counter_ns`` / 1e9)
    to bring it into the harness's frame, from the program's step starts
    matched in order to the harness's ``steps``; None if there are none or
    the counts differ."""
    if not steps or len(steps) != len(starts_ns):
        return None
    return min(p / 1e9 - s.t0 for p, s in zip(starts_ns, steps))


def of(r, rec=None) -> Program | None:
    """The recorder's records (``rec``, default the program's) in the
    frame of the readings ``r``; None where they do not match its steps."""
    rec = recorder() if rec is None else rec
    if rec is None:
        return None
    off = align(r.steps, [s.t0 for s in rec.spans if s.name == "step"])
    if off is None:
        return None
    spans = [PSpan(s.name, s.t0 / 1e9 - off,
                   None if s.t1 is None else s.t1 / 1e9 - off,
                   s.parent, s.rid, dict(s.attrs)) for s in rec.spans]
    return Program(spans, dict(rec.counters), off)


def copy_pairs(p: Program, trace) -> list:
    """(device time, program time) of each blocking device-to-host copy:
    the end of a "Memcpy DtoH" in the trace and of the ``sync`` span that
    waited for it (which ends as the copy does, plus the host's wake-up).
    Paired in order: each span with the copy nearest to where the last two
    pairs' offset and drift put it (the first five spans' median offset to
    start), within ``MATCH_S``, so that a copy missing from the trace drops
    its pair alone."""
    ends = sorted(e for _, e, name in trace.intervals if "DtoH" in name)
    hosts = [s.t1 for s in p.named("sync") if s.attrs.get("h2d") is False]
    if not ends or not hosts:
        return []

    def nearest(t):
        i = bisect.bisect_left(ends, t)
        return min(ends[max(0, i - 1):i + 1], key=lambda e: abs(e - t))
    off = statistics.median(t - nearest(t) for t in hosts[:5])
    rate, pairs = 0.0, []
    for t in hosts:
        if pairs:
            d0, t0 = pairs[-1]
            off = t0 - d0 + rate * (t - t0)
        e = nearest(t - off)
        if abs(t - e - off) < MATCH_S:
            if pairs:
                rate = (t - e - (t0 - d0)) / (t - t0)
            pairs.append((e, t))
    return pairs


def remap(trace, pairs) -> DeviceTrace:
    """The trace in the program's frame: each time shifted by the offset
    (program - device) interpolated between the copies of ``pairs``, held
    at the first and last pair's outside them."""
    e = np.array([d for d, _ in pairs])
    off = np.array([t - d for d, t in pairs])
    iv = np.array([(a, b) for a, b, _ in trace.intervals]).reshape(-1, 2)
    iv = iv + np.interp(iv, e, off)
    return DeviceTrace([(a, b, n) for (a, b), (_, _, n)
                        in zip(iv.tolist(), trace.intervals)], trace.by_name)


def alignment(pairs) -> list:
    """For each copy but the first and last: its span's end minus where the
    neighbouring pairs' offsets put the copy's end, in seconds. The error of
    ``remap`` between copies, with the host's wake-up jitter."""
    out = []
    for (d0, t0), (d1, t1), (d2, t2) in zip(pairs, pairs[1:], pairs[2:]):
        w = (d1 - d0) / (d2 - d0)
        out.append(t1 - d1 - ((t0 - d0) * (1 - w) + (t2 - d2) * w))
    return out


def union(intervals) -> list:
    """Disjoint, sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside(t: float, merged) -> bool:
    """Whether ``t`` lies in one of ``union``'s intervals."""
    i = bisect.bisect_right(merged, [t, float("inf")])
    return bool(i) and merged[i - 1][0] <= t <= merged[i - 1][1]


def overlap(a: float, b: float, steps) -> float:
    """Seconds of [a, b) inside the steps' spans."""
    return sum(max(0.0, min(b, s.t1) - max(a, s.t0)) for s in steps)
