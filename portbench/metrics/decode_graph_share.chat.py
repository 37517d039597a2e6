"""Share of the fused decode steps that the program replayed as a CUDA
graph (``serving/backends.py``, ``_DecodeGraph``), not issued op by op: its
counters ``decode_graph.replay`` over ``decode_graph.replay`` +
``decode_graph.eager``, over the traced steps. None where the program
counts neither (no fused decode call, or a program without the counters)."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    replay = p.counters.get("decode_graph.replay", 0)
    steps = replay + p.counters.get("decode_graph.eager", 0)
    if not steps:
        return None
    return 100.0 * replay / steps
