"""The ``zamba2`` family: the port's ``hybrid`` at the published Zamba2
layout (a configuration with ``hybrid_layer_ids``; ``models/hybrid.py``'s
tied blocks): every layer a Mamba2 mixer with grouped B and C; before the
mixers at the hybrid ids, one of ``num_mem_blocks`` tied attention + gated-GELU MLP blocks in
turn, reading the stream concatenated with the token embeddings, through
the application's own MLP adapter and output linear; the head tied to the
embedding where ``tie_embeddings`` says so.

Scales that are not the port's initialiser's, so that the random model is
neither degenerate nor chaotic under rounding (the values decide no
timing): with the head tied, the embedding at 1.2 / sqrt(d) (0.020 at
d = 3584, the published initializer's 0.02) keeps a token's logits near
N(0, 1.4) at every width and makes no token predict itself; the
mixers' out_proj at fan-in / sqrt(2 L) as the port, but their conv bias
drawn at 0.1 (the port's is zeros, which would leave the bias path
unchecked) and A_log at log U(1, 16) per head (the port's is a fixed ramp);
D around 1; the blocks' projections at fan-in (attention over 2 d), but
wq and wk at half of it, so that the scores spread by about 0.7 and not
1.4; each application's adapter out at 1 / sqrt(rank) and its linear at
0.3 of fan-in, so that T is a third of the stream's size; every norm's
gain around 1. At fan-in for wq, wk and the linear, the tied blocks made
the model chaotic: bf16 logits 0.37 to 0.41 of their scale from the
float32 reference's, against 0.10 to 0.13 with these (``PERF.md``).
"""
import math

import torch

from harness import weights, work

LOGIT_SPREAD = 1.2     # the embedding's std times sqrt(d_model)
CONV_BIAS_SCALE = 0.1
QK_SCALE = 0.5          # of fan-in, for the tied blocks' wq and wk
LINEAR_SCALE = 0.3      # of fan-in, for each application's linear

SMALL = {"family": "zamba2", "num_layers": 8, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 4, "head_dim": 32, "d_ff": 128, "vocab_size": 256,
         "ssm": {"d_state": 16, "head_dim": 16, "expand": 2,
                 "conv_kernel": 4, "chunk": 32, "n_groups": 2},
         "hybrid_layer_ids": [0, 1, 3, 6], "num_mem_blocks": 2,
         "adapter_rank": 8, "tie_embeddings": True, "rope_theta": 10000.0,
         "norm_eps": 1e-5, "param_dtype": "float32"}


def _sizes(m: dict):
    """(d_inner, B or C columns (groups x d_state), mixer heads)."""
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return di, s.get("n_groups", 1) * s["d_state"], di // s["head_dim"]


def draw(dr, m: dict, dt) -> dict:
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    f, r = m["d_ff"], m["adapter_rank"]
    nb, A = m["num_mem_blocks"], len(m["hybrid_layer_ids"])
    qd = m["num_heads"] * m["head_dim"]
    kvd = m["num_kv_heads"] * m["head_dim"]
    di, gn, h = _sizes(m)
    ch, K = di + 2 * gn, m["ssm"]["conv_kernel"]
    f32 = torch.float32
    # dt bias: softplus(dt_bias) log-uniform in [1e-3, 1e-1]
    dts = torch.exp(math.log(1e-3) + dr.uniform((L, h), 0.0, 1.0)
                    * (math.log(1e-1) - math.log(1e-3)))
    p = {"embed": dr.normal((V, d), LOGIT_SPREAD / math.sqrt(d), dt),
         "layers": {
             "norm": weights.gain(dr, (L, d), dt),
             "mamba": {
                 "in_proj": dr.normal((L, d, 2 * di + 2 * gn + h),
                                      1 / math.sqrt(d), dt),
                 "conv_w": dr.normal((L, K, ch), 1 / math.sqrt(K), dt),
                 "conv_b": dr.normal((L, ch), CONV_BIAS_SCALE, dt),
                 "A_log": torch.log(dr.uniform((L, h), 1.0, 16.0)),
                 "D": weights.gain(dr, (L, h), f32),
                 "dt_bias": dts + torch.log(-torch.expm1(-dts)),
                 "norm": weights.gain(dr, (L, di), dt),
                 "out_proj": dr.normal((L, di, d), 1 / math.sqrt(di * 2 * L),
                                       dt)}},
         "blocks": {
             "norm1": weights.gain(dr, (nb, 2 * d), dt),
             "attn": {"wq": dr.normal((nb, 2 * d, qd),
                                      QK_SCALE / math.sqrt(2 * d), dt),
                      "wk": dr.normal((nb, 2 * d, kvd),
                                      QK_SCALE / math.sqrt(2 * d), dt),
                      "wv": dr.normal((nb, 2 * d, kvd), 1 / math.sqrt(2 * d),
                                      dt),
                      "wo": dr.normal((nb, qd, d), 1 / math.sqrt(qd), dt)},
             "norm2": weights.gain(dr, (nb, d), dt),
             "mlp": {"gate_up": dr.normal((nb, d, 2 * f), 1 / math.sqrt(d), dt),
                     "down": dr.normal((nb, f, d), 1 / math.sqrt(f), dt)}},
         "apps": {"adapter_in": dr.normal((A, d, r), 1 / math.sqrt(d), dt),
                  "adapter_out": dr.normal((A, r, 2 * f), 1 / math.sqrt(r),
                                           dt),
                  "linear": dr.normal((A, d, d), LINEAR_SCALE / math.sqrt(d),
                                      dt)}}
    if m.get("tie_embeddings"):
        return {**p, "final_norm": weights.gain(dr, (d,), dt)}
    return {**p, **weights.head(dr, m, dt)}


def _block_weights(m: dict) -> float:
    """Weights one application of a tied block multiplies with, with its
    adapter and linear: q, k, v over 2 d, o, gate_up, down, adapter, linear."""
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    qd = m["num_heads"] * m["head_dim"]
    kvd = m["num_kv_heads"] * m["head_dim"]
    return 2 * d * qd + 2 * 2 * d * kvd + qd * d + 3 * d * f \
        + r * (d + 2 * f) + d * d


def _mixer_weights(m: dict) -> float:
    d = m["d_model"]
    di, gn, h = _sizes(m)
    return d * (2 * di + 2 * gn + h) + di * d


def token_matmul_flops(m: dict) -> float:
    """One token's weight products: all the mixers' projections and every
    application of a tied block with its adapter and linear; no head."""
    return 2.0 * (m["num_layers"] * _mixer_weights(m)
                  + len(m["hybrid_layer_ids"]) * _block_weights(m))


def attn_flops(m: dict, start: int, n: int) -> float:
    """Each application of a tied block attends."""
    return work.layer_attn_flops(m, start, n) * len(m["hybrid_layer_ids"])


def kv_bytes_per_position(m: dict) -> int:
    """Each application caches its own K and V."""
    return work.layer_kv_bytes(m) * len(m["hybrid_layer_ids"])


def ssd_work(m: dict, n: int) -> tuple[float, float]:
    """(least bytes, FLOPs) of the ``ssd`` scans of one prompt of ``n``
    tokens, over all the layers: x read and y written in bf16, a in float32,
    B and C read once, the final state written in float32; C B^T once per
    chunk and group, and per head the weighted product with x, the state
    term of every chunk after the first and the state update."""
    s = m["ssm"]
    di, gn, h = _sizes(m)
    p, N, Q = s["head_dim"], s["d_state"], s["chunk"]
    G = s.get("n_groups", 1)
    nbytes = 2 * n * di * work.BF16_BYTES + 4 * n * h \
        + 2 * n * gn * work.BF16_BYTES + 4 * h * p * N
    flops = 0
    for c0 in range(0, n, Q):
        q = min(Q, n - c0)
        tri = q * (q + 1) // 2
        flops += 2 * tri * N * G
        flops += h * (2 * tri * p + 2 * q * p * N
                      + (2 * q * N * p if c0 else 0))
    L = m["num_layers"]
    return float(L * nbytes), float(L * flops)


def decode_bytes(m: dict, rows: int, contexts) -> float:
    """Least bytes of one decode iteration that steps ``rows`` rows, of
    which the live ones attend ``contexts`` (positions each, the new one
    included): every weight read once per use (a tied block once per
    application), the head once, each row's SSM state (float32) and conv
    window read and written, and each live context's K and V read once in
    every application."""
    d, V = m["d_model"], m["vocab_size"]
    di, gn, h = _sizes(m)
    s, L = m["ssm"], m["num_layers"]
    # the mixers' small float32 and per-channel weights beside the products
    mixer = _mixer_weights(m) * work.BF16_BYTES + (
        (s["conv_kernel"] + 1) * (di + 2 * gn) + di + d) * work.BF16_BYTES \
        + 3 * h * 4
    weights_b = L * mixer + len(m["hybrid_layer_ids"]) * (
        _block_weights(m) + 3 * d) * work.BF16_BYTES + d * V * work.BF16_BYTES
    state = L * (h * s["head_dim"] * s["d_state"] * 4
                 + (s["conv_kernel"] - 1) * (di + 2 * gn) * work.BF16_BYTES)
    kv = sum(contexts) * kv_bytes_per_position(m)
    return float(weights_b + 2 * rows * state + kv)
