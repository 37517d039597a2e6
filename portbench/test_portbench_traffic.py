"""The traffic generator: one mix, the same trace of sizes and arrivals for
every seed, the token ids fixed by the seed."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import hashlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import struct  # noqa: E402

import pytest  # noqa: E402

from harness import traffic  # noqa: E402

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.generate(mix(name), 2 ** 31 + 7, 32000, 40.0)
    b = traffic.generate(mix(name), 2 ** 31 + 7, 32000, 40.0)
    assert [(r.rid, r.due, r.prompt, r.max_tokens, r.temperature, r.seed)
            for r in a] == [(r.rid, r.due, r.prompt, r.max_tokens,
                             r.temperature, r.seed) for r in b]
    assert a, "a mix made no requests in 40 s"


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_trace(name):
    """Every seed sends the same sizes at the same times; the token ids
    differ."""
    a = traffic.generate(mix(name), 11, 32000, 40.0)
    b = traffic.generate(mix(name), 12, 32000, 40.0)
    assert [r.due for r in a] == [r.due for r in b]
    assert [(len(r.prompt), r.max_tokens, r.shared, r.greedy) for r in a] == \
        [(len(r.prompt), r.max_tokens, r.shared, r.greedy) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_mix(name):
    m = mix(name)
    reqs = traffic.generate(m, 5, 32000, 40.0)
    turn, out = m["prompt"]["turn"], m["output"]
    for r in reqs:
        assert turn["lo"] <= len(r.prompt) - r.shared_len <= turn["hi"]
        assert out["lo"] <= r.max_tokens <= out["hi"]
        assert all(2 <= t < 32000 for t in r.prompt)
    greedy = sum(r.greedy for r in reqs)
    assert greedy == round(m["sampling"]["greedy_share"] * len(reqs))


def test_poisson_arrivals_keep_their_rate():
    due = traffic.arrival_times({"kind": "poisson", "rate": 5.0},
                                random.Random(1), 40.0)
    assert due == sorted(due) and 0 < due[0] and due[-1] < 40.0
    assert 0.8 * 5 * 40 < len(due) < 1.2 * 5 * 40
    with pytest.raises(ValueError):
        traffic.arrival_times({"kind": "burst", "rate": 5.0},
                              random.Random(1), 40.0)


def test_chat_prefix_due_times_as_recorded():
    """``chat_prefix``'s Poisson due times are those of the generator before
    it knew ``onoff``: the first 50, packed as float64, by their SHA-256."""
    m = mix("chat_prefix")
    due = traffic.arrival_times(
        m["arrivals"], random.Random(traffic.stable_seed("sizes", m["base_seed"])),
        48.0)
    assert len(due) == 244
    assert hashlib.sha256(b"".join(struct.pack("<d", t) for t in due[:50])) \
        .hexdigest() == \
        "770dbb7c95469c0d19ae9f5b3a4d826ce9947e9ebd20b88abff4226c23a75ed0"


ONOFF = {"kind": "onoff", "rate": 3.0, "on_s": 8.0, "off_s": 4.0}


@pytest.mark.parametrize("seed", range(6))
def test_onoff_arrivals_keep_to_the_on_phases(seed):
    """None due in an off phase, and over 48 s (four periods of 8 s on, 4
    off) a count within four standard deviations of rate x 32 s on."""
    due = traffic.arrival_times(ONOFF, random.Random(seed), 48.0)
    assert due == sorted(due) and 0 < due[0] and due[-1] < 48.0
    assert all(t % 12.0 < 8.0 for t in due)
    mean = 3.0 * 32.0
    assert abs(len(due) - mean) < 4 * mean ** 0.5


def test_onoff_times_follow_the_base_seed():
    m = {**mix("chat_prefix"), "arrivals": ONOFF}
    a = traffic.generate(m, 11, 32000, 48.0)
    b = traffic.generate(m, 12, 32000, 48.0)
    assert [r.due for r in a] == [r.due for r in b]
    c = traffic.generate({**m, "base_seed": m["base_seed"] + 1}, 11, 32000,
                         48.0)
    assert [r.due for r in a] != [r.due for r in c]
    with pytest.raises(ValueError):
        traffic.arrival_times({**ONOFF, "on_s": 0.0}, random.Random(1), 48.0)


def test_shared_prefixes_and_warmup():
    m = mix("chat_prefix")
    pre = traffic.shared_prefixes(m, 3, 32000)
    assert len(pre) == m["prompt"]["shared"]["count"]
    assert all(1024 <= len(p) <= 2048 for p in pre)
    wu = traffic.warmup(m, 3, 32000, pre)
    for i, p in enumerate(pre):      # every shared prefix is served once
        assert wu[i].prompt[:len(p)] == p
    reqs = traffic.generate(m, 3, 32000, 40.0, pre)
    assert all(r.prompt[:r.shared_len] == pre[r.shared] for r in reqs)
    assert not {r.rid for r in wu} & {r.rid for r in reqs}
