"""Share of the rows the slot backend's fused decode steps that were live
(``serving/backends.py``: every one of ``max_slots`` slots is stepped each
iteration; a live row produced its token there): the program's counters
``decode_rows.live`` over ``decode_rows.stepped``, over the traced steps.
None where the program counts neither."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None or not p.counters.get("decode_rows.stepped"):
        return None
    return 100.0 * p.counters.get("decode_rows.live", 0) \
        / p.counters["decode_rows.stepped"]
