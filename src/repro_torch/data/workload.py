"""ShareGPT-like workload generator (paper §5.2.2: benchmarks use ShareGPT
prompt/response length distributions). Deterministic given a seed.

A copy of the JAX package's ``repro/data/workload.py`` (standard library
only)."""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass


@dataclass
class WorkloadRequest:
    request_id: str
    prompt_tokens: int
    max_tokens: int
    arrival: float
    user: str = "bench"


def sharegpt_lengths(rng: random.Random, n: int,
                     prompt_mu: float = 5.1, prompt_sigma: float = 0.9,
                     out_mu: float = 5.0, out_sigma: float = 0.8,
                     lo: int = 4, hi: int = 2048):
    """Lognormal fits to the filtered ShareGPT distribution used by the vLLM
    benchmark (mean prompt ~220 tok, mean output ~190 tok, clipped 4..2048)."""
    pairs = []
    for _ in range(n):
        p = int(min(hi, max(lo, math.exp(rng.gauss(prompt_mu, prompt_sigma)))))
        o = int(min(hi, max(lo, math.exp(rng.gauss(out_mu, out_sigma)))))
        pairs.append((p, o))
    return pairs


def make_workload(n: int, rate: float, seed: int = 0, user: str = "bench",
                  prefix: str = "r", **length_kw) -> list[WorkloadRequest]:
    """``rate`` req/s Poisson arrivals; rate=inf sends everything at t=0
    (the paper's 'infinite request rate' saturation mode)."""
    rng = random.Random(seed)
    lengths = sharegpt_lengths(rng, n, **length_kw)
    t = 0.0
    out = []
    for i, (p, o) in enumerate(lengths):
        if math.isinf(rate):
            arr = 0.0
        else:
            t += rng.expovariate(rate)
            arr = t
        out.append(WorkloadRequest(request_id=f"{prefix}{i}", prompt_tokens=p,
                                   max_tokens=o, arrival=arr, user=user))
    return out


def make_bursty_workload(n_bursts: int, burst_n: int, rate: float,
                         gap: float, seed: int = 0, user: str = "bench",
                         prefix: str = "b",
                         **length_kw) -> list[WorkloadRequest]:
    """Diurnal replay trace: ``n_bursts`` active phases of ``burst_n``
    Poisson arrivals at ``rate`` req/s, separated by ``gap`` seconds of
    silence — the arrival shape that makes hot pools matter (a
    cold-start-on-demand policy pays a spin-up at every burst front)."""
    out: list[WorkloadRequest] = []
    t0 = 0.0
    for b in range(n_bursts):
        seg = make_workload(burst_n, rate, seed=seed + b, user=user,
                            prefix=f"{prefix}{b}-", **length_kw)
        for w in seg:
            w.arrival += t0
        t0 = (seg[-1].arrival if seg else t0) + gap
        out.extend(seg)
    return out


def _stable_seed(request_id: str, seed: int) -> int:
    """Process-independent digest for per-request RNG seeding. The builtin
    ``hash`` is randomized per process by PYTHONHASHSEED, which silently
    broke this module's 'deterministic given a seed' contract across
    runs/CI — crc32 gives the same stream everywhere."""
    return zlib.crc32(f"{request_id}/{seed}".encode()) & 0x7FFFFFFF


def token_ids_for(req: WorkloadRequest, vocab: int, seed: int = 0) -> list[int]:
    """Materialize synthetic prompt token ids (for real-engine runs)."""
    rng = random.Random(_stable_seed(req.request_id, seed))
    return [rng.randrange(2, vocab) for _ in range(req.prompt_tokens)]
