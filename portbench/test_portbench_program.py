"""The program's records in the harness's frame (``harness/program.py``) and
the readers of them, on synthetic steps and program spans: the alignment by
matched steps, each reader's number, and the None of a program without the
recorder and of records that match no steps."""
import sys
from collections import namedtuple
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import pytest  # noqa: E402

from harness import program, spec  # noqa: E402
from harness.readings import Readings  # noqa: E402
from repro_torch.serving.tracing import Recorder, Span  # noqa: E402

Step = namedtuple("Step", "t0 t1")     # a harness step's span
READERS = ("queue_wait_ms.chat", "k1_call_share.chat",
           "host_syncs_per_step.chat", "decode_issue_ms.chat")
BASE = 5000.0          # the program's clock (s) where the harness reads 0
LAG = 3e-6             # a program step opens this long after the harness's


def ns(t):
    """A harness-frame time as the program's clock reads it."""
    return round((BASE + t) * 1e9)


class Fake(Recorder):
    """A recorder filled by hand, in harness-frame seconds."""

    def put(self, name, t0, t1, parent=None, rid=None, **attrs):
        s = Span(self, name, ns(t0), parent, rid, attrs)
        s.t1 = ns(t1)
        self.spans.append(s)
        return len(self.spans) - 1


STEPS = [(1.0, 1.1), (1.1, 1.25), (1.25, 1.4)]


def fake():
    """Three steps: the first admits r0 (queued 30 ms) and r1 (10 ms) and
    samples a first token, the second runs a K = 1 decode, the third a
    K = 8 one that blocks 10 ms on an upload; r2's queue span ends after
    the sub-window."""
    rec = Fake()
    s0 = rec.put("step", 1.0 + LAG, 1.1 - 1e-4)
    rec.put("queue", 0.97, 1.0 + 2e-4, rid="r0")
    rec.put("queue", 0.99, 1.0 + 3e-4, rid="r1")
    rec.put("queue", 1.30, 1.5, rid="r2")
    rec.put("sync", 1.0499, 1.05, s0, site="first_token", n=1, h2d=False)
    s1 = rec.put("step", 1.1 + 2 * LAG, 1.25 - 1e-4)
    rec.put("decode.issue", 1.11, 1.13, s1, K=1, K_run=1)
    d = rec.put("decode.sync", 1.13, 1.15, s1)
    rec.put("sync", 1.13, 1.15, d, site="to_host", n=1, h2d=False)
    s2 = rec.put("step", 1.25 + LAG, 1.4 - 1e-4)
    i = rec.put("decode.issue", 1.26, 1.34, s2, K=8, K_run=8)
    rec.put("sync", 1.30, 1.31, i, site="gumbel", n=2, h2d=True)
    d = rec.put("decode.sync", 1.34, 1.36, s2)
    rec.put("sync", 1.34, 1.36, d, site="to_host", n=1, h2d=False)
    rec.counters = {"decode_calls": 2, "decode_k1.prefill": 1,
                    "syncs.to_host": 2, "syncs.put.chunk": 4,
                    "syncs.gumbel": 2}
    return rec


def readings(steps=STEPS):
    return Readings({}, {}, [Step(a, b) for a, b in steps], {}, None,
                    1.0, 1.4)


@pytest.fixture
def with_rec(monkeypatch):
    def use(rec):
        monkeypatch.setattr(program, "recorder", lambda: rec)
    return use


def test_align_matches_steps_in_order():
    steps = [Step(a, b) for a, b in STEPS]
    starts = [ns(1.0 + 5e-6), ns(1.1 + 2e-6), ns(1.25 + 9e-6)]
    assert program.align(steps, starts) == pytest.approx(BASE + 2e-6,
                                                         abs=1e-9)
    assert program.align(steps, starts[:2]) is None
    assert program.align([], []) is None


def test_of_brings_the_records_into_the_harness_frame(with_rec):
    with_rec(fake())
    p = program.of(readings())
    assert p.offset == pytest.approx(BASE + LAG, abs=1e-9)
    issue = p.named("decode.issue")[1]
    assert issue.t0 == pytest.approx(1.26 - LAG, abs=1e-8)
    assert issue.attrs == {"K": 8, "K_run": 8}
    assert p.spans[issue.parent].name == "step"
    gumbel = [s for s in p.named("sync") if s.attrs["site"] == "gumbel"]
    assert list(p.ancestors(gumbel[0])) == [p.spans.index(issue),
                                            issue.parent]
    assert p.counters["decode_calls"] == 2


def test_of_is_none_without_records_that_match(with_rec):
    with_rec(None)                       # a program with no recorder
    assert program.of(readings()) is None
    with_rec(fake())
    assert program.of(readings(steps=STEPS[:2])) is None
    with_rec(Recorder())
    assert program.of(readings()) is None


def test_recorder_is_none_where_the_program_has_none(monkeypatch):
    assert program.recorder() is not None
    monkeypatch.setitem(sys.modules, "repro_torch.serving.tracing", None)
    assert program.recorder() is None


def _read(name, r):
    return spec.reader(name).read(r)


def test_readers_on_synthetic_records(with_rec):
    with_rec(fake())
    r = readings()
    # r0 and r1 waited 30.2 and 10.3 ms; r2's span ends after the window
    assert _read("queue_wait_ms.chat", r) == pytest.approx(
        (30.2e-3 + 10.3e-3) / 2 * 1e3, abs=1e-6)
    assert _read("k1_call_share.chat", r) == pytest.approx(50.0)
    assert _read("host_syncs_per_step.chat", r) == pytest.approx(8 / 3)
    # the 10 ms the K = 8 issue blocked in its upload is not issue time
    assert _read("decode_issue_ms.chat", r) == pytest.approx(
        (0.02 + 0.08 - 0.01) / 9 * 1e3)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_a_program_without_the_recorder(
        name, with_rec):
    with_rec(None)
    assert _read(name, readings()) is None


def test_counter_readers_find_nothing_without_decode_calls(with_rec):
    rec = fake()
    rec.counters = {}
    with_rec(rec)
    assert _read("k1_call_share.chat", readings()) is None
    assert _read("host_syncs_per_step.chat", readings()) == 0.0
