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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


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
