"""Share of the slot backend's decode attention applications that ran the
hand-written slot decode kernel (``serving/backends.py`` through
``ServeStack.decode_attend``): the program's counters
``slot_decode_attn.kernel`` over ``slot_decode_attn.kernel`` +
``slot_decode_attn.plain``, over the traced steps (a replayed decode
iteration counts what its recorded iteration would have). None where the
program counts neither (no slot decode attention, or a program without
the counters)."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    kernel = p.counters.get("slot_decode_attn.kernel", 0)
    apps = kernel + p.counters.get("slot_decode_attn.plain", 0)
    if not apps:
        return None
    return 100.0 * kernel / apps
