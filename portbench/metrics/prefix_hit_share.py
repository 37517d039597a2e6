"""Share of the prompt tokens admitted that the prefix cache served
(``serving/engine.py``), from the harness's record of each admission."""


def read(r):
    admitted = sum(s.admitted for s in r.steps)
    if not admitted:
        return None
    return 100.0 * sum(s.cached for s in r.steps) / admitted
