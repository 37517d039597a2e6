"""The work a window's traffic needs, counted from the harness's own record of
the tokens it processed, the contexts they attended and the experts the model
routes them to (top-k, whatever mode the program runs its experts in), never
from the kernels' arguments; and the chip's peaks to divide it by.

A configuration's sizes are read from its file's ``model`` section (the
port's field names). What follows the family's pattern of layers (the
weight products a token meets, which layers attend and cache) its file
counts (``families/<family>.py``), from the per-layer counts here.
"""
from __future__ import annotations

from harness import spec

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _family(m: dict):
    return spec.family(m["family"])


def token_matmul_flops(m: dict) -> float:
    """FLOPs of one token's weight products through the layers, with the
    routed experts only (top-k of E), without the head."""
    return _family(m).token_matmul_flops(m)


def head_flops(m: dict) -> float:
    """FLOPs of one sampled token's logits."""
    return 2.0 * m["d_model"] * m["vocab_size"]


def layer_attn_flops(m: dict, start: int, n: int) -> float:
    """Causal attention FLOPs (q k^T and p v) of ``n`` query tokens at
    positions [start, start + n) in one attention layer, each attending
    every position up to its own."""
    keys = n * start + n * (n + 1) // 2
    return 4.0 * m["num_heads"] * m["head_dim"] * keys


def attn_flops(m: dict, start: int, n: int) -> float:
    """:func:`layer_attn_flops` over all the attention layers."""
    return _family(m).attn_flops(m, start, n)


def layer_kv_bytes(m: dict) -> int:
    """K and V bytes of one cached position in one attention layer."""
    return 2 * m["num_kv_heads"] * m["head_dim"] * BF16_BYTES


def kv_bytes_per_position(m: dict) -> int:
    """K and V bytes of one cached position over all attention layers."""
    return _family(m).kv_bytes_per_position(m)


def decode_attn_bytes(m: dict, iteration) -> float:
    """Least bytes one decode iteration's attention must move:
    ``iteration`` is a list of (context, shared prefix id, shared prefix
    length) for the sequences it steps. Each K/V byte of the distinct
    positions is read once (a shared prefix once for all the sequences
    that hold it), q read once and the output written once."""
    per_pos = kv_bytes_per_position(m)
    # q and the output: num_heads * head_dim values each in every attention
    # layer, as many as the FLOPs of one query on one key over 4
    qo = attn_flops(m, 0, 1) / 4 * 2 * BF16_BYTES
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
