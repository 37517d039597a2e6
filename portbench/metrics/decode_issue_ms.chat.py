"""Host ms to issue one decode iteration: the program's ``decode.issue``
spans (the Python loop of ``serving/backends.py`` over ``models/*`` that
queues K iterations on the device, up to the device-to-host copy), less the
``sync`` spans inside them (blocking copies, in which the host waits for
the device to drain its queue), over the iterations they ran (their
``K_run``)."""
from harness import program


def read(r):
    p = program.of(r)
    if p is None:
        return None
    issues = {i for i, s in enumerate(p.spans) if s.name == "decode.issue"}
    k = sum(p.spans[i].attrs["K_run"] for i in issues)
    if not k:
        return None
    issued = sum(p.spans[i].t1 - p.spans[i].t0 for i in issues)
    waited = sum(s.t1 - s.t0 for s in p.named("sync")
                 if any(i in issues for i in p.ancestors(s)))
    return 1e3 * (issued - waited) / k
