"""The model FLOPs the traced steps' tokens need (routed experts only, the
attention over each token's context, the head of each sampled token), over
the summed step time and the card's dense bf16 peak."""
from harness import work


def read(r):
    span = r.step_seconds()
    if not span:
        return None
    flops = work.model_flops(r.model, r.prefill_chunks(),
                             r.decode_iterations(), r.sampled_tokens())
    return 100.0 * flops / (span * work.PEAK_BF16_FLOPS)
