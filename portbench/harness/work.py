"""The work a window's traffic needs, counted from the harness's own record of
the tokens it processed, the contexts they attended and the experts the model
routes them to (top-k, whatever mode the program runs its experts in), never
from the kernels' arguments; and the chip's peaks to divide it by.

A configuration's sizes are read from its file's ``model`` section (the
port's field names).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def token_matmul_flops(m: dict) -> float:
    """FLOPs of one token's weight products through the layers, with the
    routed experts only (top-k of E), without the head."""
    d, H, KH, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * H * hd * 2 + 2 * d * KH * hd
    mlp = 3 * d * m["d_ff"]
    if m["family"] == "moe":
        E, k = m["moe"]["num_experts"], m["moe"]["top_k"]
        return 2.0 * m["num_layers"] * (attn + k * mlp + d * E)
    raise ValueError(f"no FLOP count for family {m['family']!r}")


def head_flops(m: dict) -> float:
    """FLOPs of one sampled token's logits."""
    return 2.0 * m["d_model"] * m["vocab_size"]


def attn_flops(m: dict, start: int, n: int) -> float:
    """Causal attention FLOPs (q k^T and p v) of ``n`` query tokens at
    positions [start, start + n), each attending every position up to its
    own, over all attention layers."""
    keys = n * start + n * (n + 1) // 2
    return 4.0 * m["num_heads"] * m["head_dim"] * keys * m["num_layers"]


def kv_bytes_per_position(m: dict) -> int:
    """K and V bytes of one cached position over all attention layers."""
    return 2 * m["num_kv_heads"] * m["head_dim"] * BF16_BYTES \
        * m["num_layers"]


def decode_attn_bytes(m: dict, iteration) -> float:
    """Least bytes one decode iteration's attention must move:
    ``iteration`` is a list of (context, shared prefix id, shared prefix
    length) for the sequences it steps. Each K/V byte of the distinct
    positions is read once (a shared prefix once for all the sequences
    that hold it), q read once and the output written once."""
    per_pos = kv_bytes_per_position(m)
    qo = 2 * m["num_heads"] * m["head_dim"] * BF16_BYTES \
        * m["num_layers"]
    prefixes = {}
    total = 0.0
    for ctx, pid, plen in iteration:
        if pid >= 0:
            prefixes[pid] = plen
            ctx -= plen
        total += ctx * per_pos + qo
    return total + sum(prefixes.values()) * per_pos


def model_flops(m: dict, prefill_chunks, decode_iterations,
                sampled: int) -> float:
    """The model FLOPs of a set of steps: every prompt token computed
    (``prefill_chunks``: (start, n) pairs), every decode iteration's tokens
    (lists of (context, ...) as for :func:`decode_attn_bytes`) and the
    head of every sampled token."""
    per_tok = token_matmul_flops(m)
    total = sampled * head_flops(m)
    for start, n in prefill_chunks:
        total += n * per_tok + attn_flops(m, start, n)
    for it in decode_iterations:
        for ctx, _, _ in it:
            total += per_tok + attn_flops(m, ctx - 1, 1)
    return total
