"""Acceptance of speculative decoding with the target as its own draft, in
the JAX reference engine, by parameter dtype and vocabulary width.

The seeded top-p sampler gives each nucleus candidate its Gumbel noise by
sorted rank, so a logit that moves by one unit in the last place reorders
the candidates behind it and moves the pick. With bfloat16 logits of a
wide vocabulary, the draft's sequential decode and the target's batched
verify forward round apart often enough that top-p proposals are almost
never accepted, even when the draft is the target. This runs the
reference engine (reduced llama3.2-3b: 2 layers, d_model 64; paged
backend, k = 4; 4 requests of 20 prompt tokens and 41 new tokens, so
rounds of k + 1 end at the limit) on the CPU and prints the acceptance
rate for each dtype / vocabulary / sampling mode.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/spec_acceptance_probe.py
"""
import dataclasses

import jax
import numpy as np

from repro.configs import REGISTRY, reduced
from repro.models import make_model
from repro.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro.serving.request import InferenceRequest, SamplingParams

CASES = (("float32", 256), ("bfloat16", 256), ("float32", 128256),
         ("bfloat16", 128256))
MODES = {"greedy": dict(temperature=0.0),
         "top-p": dict(temperature=0.8, top_p=0.9)}


def acceptance(dtype: str, vocab: int, sampling: dict) -> float:
    cfg = dataclasses.replace(reduced(REGISTRY["llama3.2-3b"]),
                              param_dtype=dtype, vocab_size=vocab)
    model = make_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    eng = ContinuousBatchingEngine(
        model, params,
        EngineConfig(max_slots=4, max_seq_len=128, backend="paged",
                     page_size=16, spec_tokens=4),
        draft_model=model, draft_params=params)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.add_request(InferenceRequest(
            model="m", request_id=f"r{i}",
            prompt_tokens=rng.integers(2, vocab, size=20).tolist(),
            sampling=SamplingParams(max_tokens=41, seed=i, **sampling)))
    eng.run_to_completion()
    return eng.spec_acceptance_rate()


def main() -> None:
    for dtype, vocab in CASES:
        for mode, sampling in MODES.items():
            print(f"{dtype:9s} vocab {vocab:6d} {mode:6s}: acceptance "
                  f"{acceptance(dtype, vocab, sampling):.4f}")


if __name__ == "__main__":
    main()
