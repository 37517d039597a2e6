"""Host-clock ms per thousand prompt tokens computed: the summed spans of
the engine steps that computed prompt tokens (and ran the decode batch
beside them), over those tokens."""


def read(r):
    steps = [s for s in r.steps if r.prompt_tokens(s)]
    n = sum(r.prompt_tokens(s) for s in steps)
    if not n:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / (n / 1e3)
