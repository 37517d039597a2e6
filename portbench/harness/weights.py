"""Random weights drawn from the run's seed, on the device, in the dtype they
are served in, into the port's parameter layout (the nested dict of
``repro_torch.models``: every per-layer leaf stacked on a leading layer
axis). The harness makes them itself; the program and the plain reference
are handed the same tensors.

Scales follow the port's initialisers (fan-in for projections, the residual
outputs divided by sqrt(2 L)); the norms' gains are drawn around 1 so that a
norm applied without its weight shows. Two scales of the ``moe`` family are
not the port's, so that the random model is not chaotic under rounding (the
values decide no timing: the program's dense experts compute every expert
whatever the router says): the embedding at unit scale (at the port's 0.02
every branch writes into the stream at ten times the token's own vector,
and bf16 rounding of the stream loses the token), and the router at 0.1
(confident gates, so that a near tie between a token's second and third
expert moves little). ``PERF.md`` gives the readings that chose them.
"""
from __future__ import annotations

import math

import torch

MOE_EMBED_SCALE = 1.0
MOE_ROUTER_SCALE = 0.1


class _Draw:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed % 2 ** 63)

    def normal(self, shape, scale, dtype, mean=0.0):
        """Normal(mean, scale) of ``shape``, drawn a leading slice at a time
        for stacks (a stack is one call per layer, not one per element)."""
        w = torch.empty(shape, dtype=dtype, device=self.device)
        for part in (w.unbind(0) if len(shape) >= 3 else (w,)):
            part.normal_(mean, scale, generator=self.g)
        return w

    def uniform(self, shape, lo, hi):
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return w.uniform_(lo, hi, generator=self.g)


def _attn(dr, m, L, dt):
    d, qd = m["d_model"], m["num_heads"] * m["head_dim"]
    kvd = m["num_kv_heads"] * m["head_dim"]
    lead = (L,) if L else ()
    return {"wq": dr.normal(lead + (d, qd), 1 / math.sqrt(d), dt),
            "wk": dr.normal(lead + (d, kvd), 1 / math.sqrt(d), dt),
            "wv": dr.normal(lead + (d, kvd), 1 / math.sqrt(d), dt),
            "wo": dr.normal(lead + (qd, d),
                            1 / math.sqrt(qd * 2 * m["num_layers"]), dt)}


def draw(m: dict, seed: int, device) -> dict:
    """The parameter tree of the configuration ``m`` (a config file's
    ``model`` section) for ``seed``."""
    dr = _Draw(seed, device)
    dt = getattr(torch, m["param_dtype"])
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    gain = lambda *shape: dr.normal(shape, 0.1, dt, mean=1.0)   # noqa: E731
    if m["family"] == "moe":
        E, f = m["moe"]["num_experts"], m["d_ff"]
        p = {"embed": dr.normal((V, d), MOE_EMBED_SCALE, dt)}
        p["layers"] = {
            "norm1": gain(L, d), "attn": _attn(dr, m, L, dt), "norm2": gain(L, d),
            "moe": {"router": dr.normal((L, d, E), MOE_ROUTER_SCALE,
                                        torch.float32),
                    "w1": dr.normal((L, E, d, f), 1 / math.sqrt(d), dt),
                    "w3": dr.normal((L, E, d, f), 1 / math.sqrt(d), dt),
                    "w2": dr.normal((L, E, f, d), 1 / math.sqrt(f * 2 * L), dt)}}
    else:
        raise ValueError(f"no weights for family {m['family']!r}")
    p["final_norm"] = gain(d)
    p["lm_head"] = dr.normal((d, V), 1 / math.sqrt(d), dt)
    return p
