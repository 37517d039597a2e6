"""What a per-layer reader (``metrics/<name>.py``) is handed: the traced
sub-window's steps as the harness recorded them, the work they did counted
from the traffic, and the device trace of the same interval (None where no
device was traced).

A reader is a module with ``read(r: Readings) -> float | None``; None means
it found nothing to read in this cell, and the metric is left out.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Readings:
    model: dict               # the configuration's ``model`` section
    requests: dict            # rid -> traffic.Request
    steps: list               # driver.Step of the traced sub-window
    counters: dict            # the engine's ``stats`` over those steps
    trace: object             # trace.DeviceTrace | None
    lo: float                 # the sub-window, seconds after the window opened
    hi: float

    def step_seconds(self) -> float:
        return sum(s.t1 - s.t0 for s in self.steps)

    def prompt_tokens(self, s) -> int:
        """Prompt tokens a step computed (prefix-cache hits excluded)."""
        return sum(n for _, _, n in s.prefill)

    def prefill_chunks(self):
        """(start, n) of every prompt chunk computed."""
        return [(start, n) for s in self.steps for _, start, n in s.prefill]

    def decode_iterations(self):
        """Each decode iteration of the traced steps: a list of (context,
        shared prefix id, shared prefix length) for the sequences it
        advanced. A frame of n tokens at output offset o >= 1 came from
        iterations 0..n-1 of its step's call; its token j attended the
        prompt and the first o + j outputs."""
        its = []
        for s in self.steps:
            rows = [[] for _ in range(s.K)]
            for rid, off, n in s.frames:
                if off == 0:            # the first token, sampled at prefill
                    continue
                r = self.requests[rid]
                for j in range(min(n, s.K)):
                    rows[j].append((len(r.prompt) + off + j, r.shared,
                                    r.shared_len))
            its.extend(row for row in rows if row)
        return its

    def sampled_tokens(self) -> int:
        return sum(n for s in self.steps for _, _, n in s.frames)

    def busy_in_steps(self) -> float | None:
        """Device seconds inside the steps' spans."""
        if self.trace is None:
            return None
        return sum(self.trace.busy(s.t0, s.t1) for s in self.steps)
