"""Each cell at a size the CPU tests can run in seconds: the same family,
engine path and traffic shape at reduced widths, in float32, so that the
program and the reference agree to rounding (the limit 1e-3 on the widest
gap is for these sizes alone; the cells' own limits are in
``correct/<cell>.json``)."""

CPU_LIMIT = 1e-3


class TickClock:
    """The harness's clock for the CPU tests: every reading advances it by
    ``tick`` seconds and a sleep by its length, so that a window of a few
    seconds holds the same steps however loaded the machine is."""

    def __init__(self, tick: float = 0.02):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds

MOE = {"family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
       "moe": {"num_experts": 4, "top_k": 2}, "rope_theta": 10000.0,
       "norm_eps": 1e-5, "param_dtype": "float32"}
CORRECT = {"sample_tokens": 64, "sample_requests": 4,
           "limits": {"widest_gap": CPU_LIMIT, "mean_gap": CPU_LIMIT}}
TRACE = {"start_s": 1.0, "seconds": 1.0}

CELLS = {
    "phi35moe-chat-prefix": {
        "model": MOE, "correct": CORRECT,
        "engine": {"backend": "paged", "use_kernel": True, "page_size": 16,
                   "enable_prefix_cache": True, "chunked_prefill_budget": 64,
                   "decode_steps_per_sync": 8, "max_slots": 8,
                   "max_seq_len": 512, "num_pages": 200},
        "mix": {"arrivals": {"kind": "poisson", "rate": 4.0},
                "prompt": {"shared": {"count": 3, "len_lo": 40, "len_hi": 80,
                                      "zipf_s": 1.1},
                           "turn": {"mu": 3.0, "sigma": 0.5, "lo": 4, "hi": 60}},
                "output": {"mu": 2.5, "sigma": 0.5, "lo": 4, "hi": 40},
                "trace": TRACE, "drain_s": 30}},
}
