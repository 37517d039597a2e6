"""The reader of ``mixer_kernel_share.burst`` on hand-made records: the
share of the Mamba2 mixers' decode steps that ran the mixer decode kernel,
and nothing where the program counts neither."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import pytest  # noqa: E402

from harness import program, spec  # noqa: E402
from harness.driver import Step  # noqa: E402
from harness.readings import Readings  # noqa: E402


def _readings():
    steps = [Step(0.0, 0.1, K=2, frames=[("r0", 3, 2)])]
    return Readings({}, {}, steps, {}, None, 0.0, 1.0)


@pytest.mark.parametrize("counters, share", [
    ({"mixer_decode.kernel": 162}, 100.0),
    ({"mixer_decode.kernel": 81, "mixer_decode.plain": 243}, 25.0),
    ({"mixer_decode.plain": 81}, 0.0),
    ({"slot_decode_attn.kernel": 13}, None),
    ({}, None),
])
def test_mixer_kernel_share(monkeypatch, counters, share):
    monkeypatch.setattr(program, "of", lambda r: program.Program(
        [], counters, 0.0))
    got = spec.reader("mixer_kernel_share.burst").read(_readings())
    assert got == (None if share is None else pytest.approx(share))


def test_mixer_kernel_share_without_records(monkeypatch):
    monkeypatch.setattr(program, "of", lambda r: None)
    assert spec.reader("mixer_kernel_share.burst").read(_readings()) is None
