"""Client-side streaming helpers: collect ``StreamDelta`` frames back into
a full response and observe first-token / inter-token timing.

The gateway delivers frames through a plain callback (the DES analogue of
an SSE connection). ``StreamAssembler`` is that callback: it checks frame
ordering, accumulates tokens/counts, records arrival timestamps (TTFT and
per-frame inter-token gaps as seen by the CLIENT), and exposes the
reassembled stream — which must be token-identical to the non-streamed
response for the same request.

A copy of the JAX package's ``repro/api/stream.py``.
"""
from __future__ import annotations

from repro_torch.api.schemas import StreamDelta


class StreamAssembler:
    """Reassemble a streamed response; call the instance with each frame."""

    def __init__(self, clock=None) -> None:
        self._clock = clock
        self.deltas: list[StreamDelta] = []
        self.tokens: list = []            # token ids (data plane)
        self.n_tokens = 0                 # token count (both planes)
        self.finish_reason = ""
        self.finished = False
        self.arrivals: list[float] = []   # client-side receive times

    def __call__(self, delta: StreamDelta):
        if delta.index != len(self.deltas):
            raise RuntimeError(
                f"stream frame out of order: got index {delta.index}, "
                f"expected {len(self.deltas)}")
        if self.finished:
            raise RuntimeError("frame after the finished frame")
        self.deltas.append(delta)
        if self._clock is not None:
            self.arrivals.append(self._clock.now())
        if delta.tokens is not None:
            self.tokens.extend(delta.tokens)
        self.n_tokens += delta.n_tokens
        if delta.finished:
            self.finished = True
            self.finish_reason = delta.finish_reason

    # -- client-observed timing -------------------------------------------
    @property
    def ttft(self) -> float | None:
        return self.arrivals[0] if self.arrivals else None

    @property
    def inter_token_gaps(self) -> list[float]:
        return [b - a for a, b in zip(self.arrivals, self.arrivals[1:])]
