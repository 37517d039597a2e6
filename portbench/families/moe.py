"""The ``moe`` family (phi3.5-moe's layers as the port writes them): every
layer a grouped-query attention and a mixture of SwiGLU experts behind a
softmax router, top-k of E.

Two scales of the weights are not the port's, so that the random model is
not chaotic under rounding (the values decide no timing: the program's
dense experts compute every expert whatever the router says): the
embedding at unit scale (at the port's 0.02 every branch writes into the
stream at ten times the token's own vector, and bf16 rounding of the stream
loses the token), and the router at 0.1 (confident gates, so that a near tie
between a token's second and third expert moves little). ``PERF.md`` gives
the readings that chose them.
"""
import math

import torch

from harness import weights, work

EMBED_SCALE = 1.0
ROUTER_SCALE = 0.1

SMALL = {"family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
         "moe": {"num_experts": 4, "top_k": 2}, "rope_theta": 10000.0,
         "norm_eps": 1e-5, "param_dtype": "float32"}


def draw(dr, m: dict, dt) -> dict:
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    E, f = m["moe"]["num_experts"], m["d_ff"]
    p = {"embed": dr.normal((V, d), EMBED_SCALE, dt)}
    p["layers"] = {
        "norm1": weights.gain(dr, (L, d), dt), "attn": weights.attn(dr, m, L, dt),
        "norm2": weights.gain(dr, (L, d), dt),
        "moe": {"router": dr.normal((L, d, E), ROUTER_SCALE, torch.float32),
                "w1": dr.normal((L, E, d, f), 1 / math.sqrt(d), dt),
                "w3": dr.normal((L, E, d, f), 1 / math.sqrt(d), dt),
                "w2": dr.normal((L, E, f, d), 1 / math.sqrt(f * 2 * L), dt)}}
    return {**p, **weights.head(dr, m, dt)}


def token_matmul_flops(m: dict) -> float:
    """One token's weight products through the layers, with the routed
    experts only (top-k of E), without the head."""
    d, H, KH, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * H * hd * 2 + 2 * d * KH * hd
    mlp = 3 * d * m["d_ff"]
    E, k = m["moe"]["num_experts"], m["moe"]["top_k"]
    return 2.0 * m["num_layers"] * (attn + k * mlp + d * E)


def attn_flops(m: dict, start: int, n: int) -> float:
    """Every layer attends."""
    return work.layer_attn_flops(m, start, n) * m["num_layers"]


def kv_bytes_per_position(m: dict) -> int:
    """Every layer caches K and V."""
    return work.layer_kv_bytes(m) * m["num_layers"]
