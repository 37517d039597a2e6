"""Share of the slot backend's Mamba2 mixer decode steps that ran the
hand-written mixer decode kernel (``ServeStack.mixer`` in a decode step):
the program's counters ``mixer_decode.kernel`` over ``mixer_decode.kernel``
+ ``mixer_decode.plain``, over the traced steps (a replayed decode
iteration counts what its recorded iteration would have). None where the
program counts neither (no mixer decode step, or a program without the
counters)."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    kernel = p.counters.get("mixer_decode.kernel", 0)
    steps = kernel + p.counters.get("mixer_decode.plain", 0)
    if not steps:
        return None
    return 100.0 * kernel / steps
