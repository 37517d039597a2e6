"""Mean ms a request waited in the engine's queue: the program's ``queue``
spans (``add_request``, or a preemption's requeue, to admission by
``serving/engine.py`` under ``scheduler.py``'s policy) that end in the
traced sub-window. The sub-window admits a dozen or so requests, too few
for a tail."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    waits = [s.t1 - s.t0 for s in p.named("queue") if r.lo <= s.t1 <= r.hi]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
