"""Tokens delivered per host sync of the decode loop (``serving/engine.py``
``stats``: ``decode_tokens`` over ``decode_syncs``); K = 8 falls back to 1
while a prefill is in flight or the batch changed."""


def read(r):
    syncs = r.counters.get("decode_syncs", 0)
    if not syncs:
        return None
    return r.counters["decode_tokens"] / syncs
