"""Host-clock ms of one decode iteration: the summed spans of the engine
steps that computed no prompt token, over the decode iterations in them
(the model step through ``serving/backends.py`` and ``models/*``)."""


def read(r):
    steps = [s for s in r.steps if s.K and not r.prompt_tokens(s)]
    iters = sum(s.K for s in steps)
    if not iters:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / iters
