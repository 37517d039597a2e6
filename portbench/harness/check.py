"""Whether what the timed path served is right: a sample of the greedy
requests it finished, drawn from the seed with the longest among them, is
run through the plain float32 reference teacher-forced (each prompt with
the tokens the program served), and each served token is judged by how far
its reference logit lies below the reference's best at that position.

The numbers compared, each beside its limit:

* ``widest_gap``, the largest such gap over the sample, and ``mean_gap``,
  their mean: each against the cell's limit for it in
  ``correct/<cell>.json`` (``limits``), where the cell has one: a limit is
  set from the program's readings over a dozen seeds and the control's
  (``PERF.md`` gives them), and a number whose readings do not separate
  has none and is printed without being compared;
* ``short_or_long``: finished requests whose output is not exactly the
  ``max_tokens`` they asked for (no stop token is set), limit 0;
* ``bad_ids``: served token ids outside the vocabulary, limit 0.
"""
from __future__ import annotations

import random

import torch

from harness import spec
from harness.traffic import stable_seed


def sample(timelines: dict, requests: dict, seed: int, tokens: int,
           max_requests: int) -> list[str]:
    """Ids of finished greedy requests: the longest (prompt and output)
    first, then others in an order drawn from the seed, until ``tokens``
    served tokens or ``max_requests`` requests."""
    done = [rid for rid, t in timelines.items()
            if t.finished is not None and requests[rid].greedy and t.tokens]
    if not done:
        return []
    done.sort()
    longest = max(done, key=lambda r: (timelines[r].prompt_len
                                       + len(timelines[r].tokens), r))
    rest = [r for r in done if r != longest]
    random.Random(stable_seed("sample", seed)).shuffle(rest)
    out, n = [longest], len(timelines[longest].tokens)
    for rid in rest:
        if n >= tokens or len(out) >= max_requests:
            break
        out.append(rid)
        n += len(timelines[rid].tokens)
    return out


def served_gaps(family: str, params, m: dict, seqs, precision="float32"):
    """``seqs``: (prompt, served tokens) pairs. Returns, per sequence, the
    gap of each served token below the reference's best logit at its
    position; with ``precision`` other than float32, also the gap of the
    token that precision puts first (the control's reading)."""
    ref = spec.reference(family)
    feed = [(p + s[:-1], len(p) - 1) for p, s in seqs]
    exact = ref.logits(params, m, feed)
    if precision == "float32":
        picks = [s for _, s in seqs]
    else:
        low = ref.logits(params, m, feed, precision)
        picks = [lg.argmax(-1).tolist() for lg in low]
    gaps = []
    for lg, pick in zip(exact, picks):
        idx = torch.as_tensor(pick, device=lg.device)
        best = lg.max(-1).values
        gaps.append((best - lg.gather(-1, idx[:, None])[:, 0]).tolist())
    return gaps


def judge(m: dict, c: dict, params, timelines: dict, requests: dict,
          seed: int, log, precision: str = "float32") -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) for a run's served requests, with
    the configuration's ``model`` section ``m`` and the cell's limits and
    sample sizes ``c``. ``log`` gets one line per number. With
    ``precision`` other than float32 the control takes the program's
    place: at each served position the token the reference computed in
    that precision puts first is judged instead of the served one."""
    V = m["vocab_size"]
    short_or_long = bad_ids = 0
    for rid, t in timelines.items():
        if t.finished is not None and len(t.tokens) != requests[rid].max_tokens:
            short_or_long += 1
        bad_ids += sum(1 for x in t.tokens if not 0 <= x < V)
    pick = sample(timelines, requests, seed, c["sample_tokens"],
                  c["sample_requests"])
    seqs = [(requests[r].prompt, timelines[r].tokens) for r in pick]
    flat = [x for g in served_gaps(m["family"], params, m, seqs, precision)
            for x in g] if seqs else []
    inf = float("inf")
    gaps = {"widest_gap": max(flat) if flat else inf,
            "mean_gap": sum(flat) / len(flat) if flat else inf}
    numbers = {k: [v, c["limits"].get(k)] for k, v in gaps.items()}
    numbers.update({"short_or_long": [short_or_long, 0], "bad_ids": [bad_ids, 0]})
    compared = {k: v for k, v in numbers.items() if v[1] is not None}
    ok = len(compared) > 2 and all(v <= lim for v, lim in compared.values())
    log(f"checked {len(flat)} served tokens of {len(pick)} greedy requests"
        + ("" if precision == "float32" else f" as the {precision} control"))
    for name, (v, lim) in numbers.items():
        log(f"check {name} {v!r} limit {lim!r}")
    return ok, numbers
