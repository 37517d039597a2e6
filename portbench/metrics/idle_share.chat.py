"""Share of the engine steps' time in which nothing ran on the device
(1 - device busy time inside the steps' spans over those spans)."""


def read(r):
    busy = r.busy_in_steps()
    span = r.step_seconds()
    if busy is None or not span:
        return None
    return 100.0 * (1.0 - busy / span)
