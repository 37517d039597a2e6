"""Each cell at a size the CPU tests can run in seconds
(``small/<cell>.json``): the same family, engine path and traffic shape at
reduced widths, in float32, so that the program and the reference agree to
rounding. A file holds the sections of the cell it replaces: ``model``,
``engine``, ``mix`` (merged over the cell's own mix) and ``correct`` (the
limit ``CPU_LIMIT`` on the gaps is for these sizes alone; the cells' own
limits are in ``correct/<cell>.json``)."""
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent

CPU_LIMIT = 1e-3
TRACE = {"start_s": 1.0, "seconds": 1.0}


class TickClock:
    """The harness's clock for the CPU tests: every reading advances it by
    ``tick`` seconds and a sleep by its length, so that a window of a few
    seconds holds the same steps however loaded the machine is."""

    def __init__(self, tick: float = 0.02):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def names() -> list[str]:
    """The cells that have a small version."""
    return sorted(p.stem for p in (HERE / "small").glob("*.json"))


def load(name: str) -> dict:
    """The small version of cell ``name``, as ``harness.cell.run``'s
    ``overrides``; its mix traces ``TRACE`` where the file names no
    sub-window."""
    small = json.loads((HERE / "small" / f"{name}.json").read_text())
    small["mix"] = {"trace": TRACE, **small["mix"]}
    return small
