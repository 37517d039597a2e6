"""The decode iterations' least bytes at the HBM rate over their device
time: for each engine step that computed no prompt token, its K
iterations each move every weight once per use, the state of every stepped
row read and written and the K/V of the live contexts (the family's
``decode_bytes``), at 3.35 TB/s, over the device-busy seconds inside the
steps' spans (the model step through ``serving/backends.py`` and
``models/*``; host issue and syncs the device waits through are left out).
The stepped rows an iteration are the program's ``decode_rows.stepped``
over the traced iterations. None without a device trace, where the program
does not count the rows, or where the family has no such count."""
import dataclasses

from harness import program, spec, work


def read(r):
    count = getattr(spec.family(r.model["family"]), "decode_bytes", None)
    p = program.of(r)
    iters = sum(s.K for s in r.steps)
    if r.trace is None or count is None or p is None or not iters \
            or not p.counters.get("decode_rows.stepped"):
        return None
    rows = p.counters["decode_rows.stepped"] / iters
    steps = [s for s in r.steps if s.K and not r.prompt_tokens(s)]
    need = busy = 0.0
    for s in steps:
        one = dataclasses.replace(r, steps=[s])
        live = one.decode_iterations()
        # iterations whose rows all finished produce no frame: none live
        live += [[]] * (s.K - len(live))
        need += sum(count(r.model, rows, [c for c, _, _ in it])
                    for it in live)
        busy += r.trace.busy(s.t0, s.t1)
    if not busy:
        return None
    return 100.0 * need / work.PEAK_HBM_BYTES_PER_S / busy
