"""Share of the fused decode calls (``serving/engine.py``
``_decode_fused``) that fell back to K = 1 because a prefill was in flight
or the batch had changed: the program's counters ``decode_k1.prefill`` and
``decode_k1.batch_changed`` over ``decode_calls``."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None or not p.counters.get("decode_calls"):
        return None
    c = p.counters
    k1 = c.get("decode_k1.prefill", 0) + c.get("decode_k1.batch_changed", 0)
    return 100.0 * k1 / c["decode_calls"]
