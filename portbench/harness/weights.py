"""Random weights drawn from the run's seed, on the device, in the dtype they
are served in, into the port's parameter layout (the nested dict of
``repro_torch.models``: every per-layer leaf stacked on a leading layer
axis). The harness makes them itself; the program and the plain reference
are handed the same tensors.

Scales follow the port's initialisers (fan-in for projections, the residual
outputs divided by sqrt(2 L)); the norms' gains are drawn around 1 so that a
norm applied without its weight shows. Each family draws its own tree
(``families/<family>.py``, ``draw``) from the parts here, and says where
its scales depart from the port's.
"""
from __future__ import annotations

import math

import torch

from harness import spec


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


def gain(dr: _Draw, shape, dt):
    """A norm's weights, around 1."""
    return dr.normal(shape, 0.1, dt, mean=1.0)


def attn(dr: _Draw, m: dict, L: int, dt) -> dict:
    """An attention block's projections, stacked over ``L`` layers (none
    for ``L`` 0)."""
    d, qd = m["d_model"], m["num_heads"] * m["head_dim"]
    kvd = m["num_kv_heads"] * m["head_dim"]
    lead = (L,) if L else ()
    return {"wq": dr.normal(lead + (d, qd), 1 / math.sqrt(d), dt),
            "wk": dr.normal(lead + (d, kvd), 1 / math.sqrt(d), dt),
            "wv": dr.normal(lead + (d, kvd), 1 / math.sqrt(d), dt),
            "wo": dr.normal(lead + (qd, d),
                            1 / math.sqrt(qd * 2 * m["num_layers"]), dt)}


def head(dr: _Draw, m: dict, dt) -> dict:
    """The final norm and the untied head."""
    d = m["d_model"]
    return {"final_norm": gain(dr, (d,), dt),
            "lm_head": dr.normal((d, m["vocab_size"]), 1 / math.sqrt(d), dt)}


def draw(m: dict, seed: int, device) -> dict:
    """The parameter tree of the configuration ``m`` (a config file's
    ``model`` section) for ``seed``, drawn by its family's file."""
    return spec.family(m["family"]).draw(_Draw(seed, device), m,
                                         getattr(torch, m["param_dtype"]))
