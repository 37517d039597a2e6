"""Offline batch engine (the port of ``repro/serving/offline.py``; paper
§4.4): a dedicated allocation processes a whole request file with no
online-serving mediation -- admit everything, loop until drained, report
aggregate throughput."""
from __future__ import annotations

import time

from repro_torch.models import LM
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig


def run_batch(model: LM, params, requests,
              engine_cfg: EngineConfig | None = None, clock=None,
              device=None):
    """Returns (outputs, stats). Requests are processed with maximum
    batching and zero scheduling overhead between steps. ``stats`` is the
    engine's plus ``wall_s``, ``output_tokens``, ``output_tok_per_s`` and
    ``req_per_s``. ``device``: as for the engine (default the CUDA
    device)."""
    eng = ContinuousBatchingEngine(model, params, engine_cfg, clock=clock,
                                   device=device)
    t0 = time.monotonic()
    for r in requests:
        eng.add_request(r)
    outputs = eng.run_to_completion()
    dt = time.monotonic() - t0
    total_out = sum(o.num_output_tokens for o in outputs)
    stats = dict(eng.stats)
    stats.update({
        "wall_s": dt,
        "output_tokens": total_out,
        "output_tok_per_s": total_out / dt if dt > 0 else 0.0,
        "req_per_s": len(outputs) / dt if dt > 0 else 0.0,
    })
    return outputs, stats
