"""Share of the engine steps' time in which the device sat idle after the
host blocked on a transfer: the idle gaps of the device trace that open
while the host is inside one of the program's ``sync`` spans (within
``TOL_S``), their time inside the steps, over the steps' summed time. The
rest of ``idle_share.chat`` is idle while the host issues work or keeps
its books. The trace is first mapped into the program's frame between its
blocking device-to-host copies (``program.remap``); None where fewer than
three copies pair or the tenth-worst ``program.alignment`` of a copy
exceeds ``TOL_S``."""
import statistics

from harness import program

# the error allowed between a device gap's start and the host's sync span:
# the copies' alignment after the remap read 37 and 73 us at the ninth
# decile on the card (PERF.md, "The clock")
TOL_S = 150e-6


def read(r):
    if r.trace is None or not r.steps:
        return None
    p = program.of(r)
    if p is None:
        return None
    pairs = program.copy_pairs(p, r.trace)
    if len(pairs) < 3:
        return None
    err = [abs(x) for x in program.alignment(pairs)]
    if (statistics.quantiles(err, n=10)[-1] if len(err) > 1 else err[0]) \
            > TOL_S:
        return None
    trace = program.remap(r.trace, pairs)
    syncs = program.union((s.t0 - TOL_S, s.t1 + TOL_S)
                          for s in p.named("sync"))
    idle = sum(program.overlap(a, b, r.steps)
               for a, b in trace.gaps(r.lo, r.hi) if program.inside(a, syncs))
    return 100.0 * idle / r.step_seconds()
