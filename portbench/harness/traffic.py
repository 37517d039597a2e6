"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and makes the requests of a run.

What a run's ``--seed`` changes and what it does not:

* The mix's ``base_seed`` fixes the arrival times, which (prompt, output,
  shared prefix, sampling mode) sizes arrive when, and the shared
  prefixes' lengths: a fixed trace. Every seed serves the same work at the
  same times.
* The run's seed fixes every token id and every sampling seed (and, in the
  harness, the weights).

With the sizes in an order drawn from the run's seed instead, the p90 of
TTFT of a bursty cell spread by a fifth from seed to seed against a tenth
between two runs of one seed (``PERF.md``): which request lands in a burst
decides the queue.

Lengths follow the ShareGPT lognormal fits of the port's
``repro_torch/data/workload.py`` (``sharegpt_lengths``), copied here and
rewritten to draw one length set per mix; ``token_ids`` is that module's
``token_ids_for`` rewritten on numpy, so that a million prompt tokens take
milliseconds.
"""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    """One request of a run: when it is due (seconds after the window
    opens), its prompt and how it is sampled."""
    rid: str
    due: float
    prompt: list
    max_tokens: int
    temperature: float
    top_p: float
    seed: int
    shared: int = -1           # index of the shared prefix, -1 for none
    shared_len: int = 0        # tokens of the prompt that are that prefix

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def lognormal_lengths(rng: random.Random, n: int, mu: float, sigma: float,
                      lo: int, hi: int) -> list[int]:
    """``n`` lengths exp(N(mu, sigma)) clipped to [lo, hi] (the lognormal fit
    of ``sharegpt_lengths``; ``mu`` is the log of the median)."""
    return [int(min(hi, max(lo, math.exp(rng.gauss(mu, sigma)))))
            for _ in range(n)]


def stable_seed(*parts) -> int:
    """A process-independent 31-bit digest (``hash`` is salted per
    process)."""
    return zlib.crc32("/".join(map(str, parts)).encode()) & 0x7FFFFFFF


def token_ids(key: str, seed: int, n: int, vocab: int) -> list[int]:
    """``n`` token ids in [2, vocab), fixed by (key, seed)."""
    seed %= 2 ** 64
    rng = np.random.default_rng([stable_seed(key), seed & 0xFFFFFFFF,
                                 seed >> 32])
    return rng.integers(2, vocab, size=n).tolist()


def _lengths(spec: dict, rng: random.Random, n: int) -> list[int]:
    mu = spec["mu"] if "mu" in spec else math.log(spec["median"])
    return lognormal_lengths(rng, n, mu, spec["sigma"], spec["lo"],
                             spec["hi"])


def arrival_times(arr: dict, rng: random.Random, horizon: float) -> list[float]:
    """Due times in [0, horizon) of Poisson arrivals at ``rate`` a second:
    throughout (``kind`` ``poisson``), or in on phases of ``on_s`` seconds
    that alternate with off phases of ``off_s`` seconds with none, the first
    on phase from 0 (``onoff``). The Poisson process runs on the on phases'
    clock; each time is then moved past the off phases before it."""
    if arr["kind"] == "poisson":
        on, off = math.inf, 0.0
    elif arr["kind"] == "onoff":
        on, off = arr["on_s"], arr["off_s"]
        if not on > 0 or not off >= 0:
            raise ValueError(f"onoff needs on_s > 0 and off_s >= 0: {arr}")
    else:
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    out, t = [], 0.0
    while True:
        t += rng.expovariate(arr["rate"])
        due = t + t // on * off
        if due >= horizon:
            return out
        out.append(due)


def shared_prefix_lengths(mix: dict) -> list[int]:
    """Lengths of the mix's shared prefixes (system prompts), fixed by its
    base seed."""
    sh = mix["prompt"].get("shared")
    if not sh:
        return []
    rng = random.Random(stable_seed("shared", mix["base_seed"]))
    return [rng.randint(sh["len_lo"], sh["len_hi"]) for _ in range(sh["count"])]


def shared_prefixes(mix: dict, seed: int, vocab: int) -> list[list[int]]:
    return [token_ids(f"shared{i}", seed, n, vocab)
            for i, n in enumerate(shared_prefix_lengths(mix))]


def generate(mix: dict, seed: int, vocab: int, horizon: float,
             prefixes: list[list[int]] | None = None) -> list[Request]:
    """The run's requests, ordered by due time. ``horizon``: the last due
    time generated (the window's length: nothing later is sent)."""
    base = random.Random(stable_seed("sizes", mix["base_seed"]))
    due = arrival_times(mix["arrivals"], base, horizon)
    n = len(due)
    p = mix["prompt"]
    turns = _lengths(p["turn"], base, n)
    outs = _lengths(mix["output"], base, n)
    sh = p.get("shared")
    if sh:
        w = [1.0 / (i + 1) ** sh["zipf_s"] for i in range(sh["count"])]
        which = base.choices(range(sh["count"]), weights=w, k=n)
    else:
        which = [-1] * n
    samp = mix["sampling"]
    n_greedy = round(samp["greedy_share"] * n)
    greedy = [True] * n_greedy + [False] * (n - n_greedy)
    base.shuffle(greedy)
    sizes = list(zip(turns, outs, which, greedy))
    if prefixes is None:
        prefixes = shared_prefixes(mix, seed, vocab)
    reqs = []
    for i, (t, (turn, out, s, g)) in enumerate(zip(due, sizes)):
        rid = f"r{i}"
        head = prefixes[s] if s >= 0 else []
        reqs.append(Request(
            rid=rid, due=t, prompt=head + token_ids(rid, seed, turn, vocab),
            max_tokens=out, temperature=0.0 if g else samp["temperature"],
            top_p=1.0 if g else samp["top_p"], seed=stable_seed(rid, seed),
            shared=s, shared_len=len(head)))
    return reqs


def warmup(mix: dict, seed: int, vocab: int,
           prefixes: list[list[int]] | None = None) -> list[Request]:
    """Requests served before the window: each shared prefix once, then
    ``warmup.requests`` more of the mix's sizes, greedy and sampled, all due
    at once. Their token ids are their own; the prefixes are the window's,
    so the prefix cache holds them when the window opens."""
    wu = mix.get("warmup", {})
    if prefixes is None:
        prefixes = shared_prefixes(mix, seed, vocab)
    rng = random.Random(stable_seed("warmup", mix["base_seed"]))
    samp = mix["sampling"]
    out = []
    n = len(prefixes) + wu.get("requests", 0)
    turns = _lengths(mix["prompt"]["turn"], rng, n)
    outs = _lengths(mix["output"], rng, n)
    for i in range(n):
        rid = f"w{i}"
        head = prefixes[i] if i < len(prefixes) else []
        g = i % 2 == 0
        out.append(Request(
            rid=rid, due=0.0, prompt=head + token_ids(rid, seed, turns[i], vocab),
            max_tokens=min(outs[i], wu.get("max_tokens", outs[i])),
            temperature=0.0 if g else samp["temperature"],
            top_p=1.0 if g else samp["top_p"], seed=stable_seed(rid, seed),
            shared=i if i < len(prefixes) else -1, shared_len=len(head)))
    return out
