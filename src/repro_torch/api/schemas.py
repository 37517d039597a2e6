"""Wire schemas the serving engine emits.

Only :class:`StreamDelta` so far: the port's engine streams token frames
through it. A field-for-field copy of ``StreamDelta`` in the JAX package's
``api/schemas.py``; the rest of that module (requests, responses, batches,
the versioned wire envelope) has not been ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StreamDelta:
    """One incremental chunk of a streamed response (SSE frame analogue).

    ``tokens`` holds the emitted ids on the data plane; the DES control
    plane streams counts only (``tokens=None``, ``n_tokens`` set). The
    final frame has ``finished=True`` + ``finish_reason`` and no tokens.

    ``offset`` is the stream position of the frame's FIRST token: if a
    fault-tolerance requeue restarts generation, re-emitted frames carry
    offsets the receiver has already passed and are deduplicated at the
    gateway — the client never sees a token twice."""
    id: str = ""
    index: int = 0                        # 0-based frame sequence number
    tokens: list | None = None
    n_tokens: int = 0
    offset: int = 0                       # stream position of tokens[0]
    created: float = 0.0                  # engine-side emit time
    finished: bool = False
    finish_reason: str = ""

    object = "chat.completion.chunk"

    def to_dict(self) -> dict:
        d = {"id": self.id, "object": self.object, "index": self.index,
             "n_tokens": self.n_tokens, "offset": self.offset,
             "created": round(self.created, 6)}
        if self.tokens is not None:
            d["tokens"] = self.tokens
        if self.finished:
            d["finished"] = True
            d["finish_reason"] = self.finish_reason
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StreamDelta":
        return cls(id=str(d.get("id", "")), index=int(d.get("index", 0)),
                   tokens=d.get("tokens"),
                   n_tokens=int(d.get("n_tokens", 0)),
                   offset=int(d.get("offset", 0)),
                   created=float(d.get("created", 0.0)),
                   finished=bool(d.get("finished", False)),
                   finish_reason=str(d.get("finish_reason", "")))
