"""The window's arithmetic: percentiles and the end-to-end metrics, from the
harness's own timeline of each request (due time, token arrival times).

Every time here is a host-clock second after the window opened.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class Timeline:
    """What the harness saw of one request: when it was due, when it was
    handed to the engine, and when each frame of tokens reached it."""
    rid: str
    due: float
    prompt_len: int
    max_tokens: int
    added: float | None = None
    frames: list = field(default_factory=list)    # (time, n_tokens)
    finished: float | None = None
    tokens: list = field(default_factory=list)

    @property
    def first(self) -> float | None:
        return self.frames[0][0] if self.frames else None

    @property
    def last(self) -> float | None:
        return self.frames[-1][0] if self.frames else None


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) with linear interpolation between
    order statistics (numpy's default). Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_ms(tl: Timeline) -> float | None:
    """From the moment the request was due to its first token."""
    return None if tl.first is None else (tl.first - tl.due) * 1e3


def tpot_ms(tl: Timeline) -> float | None:
    """(last token time - first token time) / (output tokens - 1), for a
    finished request of two tokens or more."""
    n = sum(k for _, k in tl.frames)
    if tl.finished is None or n < 2:
        return None
    return (tl.last - tl.first) * 1e3 / (n - 1)


def chat_metrics(timelines, seconds: float) -> dict:
    """p90 (and p50) of TTFT and TPOT over every request due inside the
    window. A request that never
    finished is ``failed`` and stands in both tails as an infinite time,
    so it can never leave a tail shorter; a percentile that lands on one is
    not reported."""
    due = [t for t in timelines if t.due < seconds]
    inf = math.inf
    ttft = [inf if ttft_ms(t) is None else ttft_ms(t) for t in due]
    tpot = [inf if tpot_ms(t) is None else tpot_ms(t) for t in due]
    out = {"attempted": len(due),
           "failed": sum(1 for t in due if t.finished is None)}
    if not due:
        return out
    for name, xs in (("ttft", ttft), ("tpot", tpot)):
        for q in (50, 90):
            v = percentile(xs, q)
            if math.isfinite(v):
                out[f"{name}_p{q}_ms"] = v
    return out

