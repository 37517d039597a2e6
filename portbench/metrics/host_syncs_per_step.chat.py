"""Blocking host-device transfers per engine step: the program's
``syncs.<site>`` counters (``serving/backends.py``, ``sampler.py``,
``engine.py``; each copy to or from pageable memory waits for the stream
to drain) over the traced steps."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    n = sum(v for k, v in p.counters.items() if k.startswith("syncs."))
    return n / len(r.steps)
