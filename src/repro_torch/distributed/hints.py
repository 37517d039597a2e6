"""Activation hints read inside model code (the port of
``repro/distributed/hints.py``).

The default is OFF (no policy). A caller opts in with
``use_hints(ShardingHints(...))`` around a call. On one device the only
hint that changes what runs is ``ce_chunk``: ``LM.train_loss`` then
computes the LM loss in vocab chunks of that size (``_chunked_ce``), never
materializing the full (tokens, V) logits.

The reference's ``constrain`` and ``constrain_batch`` insert mesh sharding
constraints; they are not here and wait for tensor parallelism (ROADMAP
Queue 1 item 11), as do the mesh axes below, which the port carries but
does not read.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


@dataclass(frozen=True)
class ShardingHints:
    # axes that shard the batch dim of attention inputs (q/k/v) during
    # full-sequence attention; None disables the reshard
    attn_dp: tuple | None = None
    # axes the output is constrained back to (the model's default DP axes)
    batch_axes: tuple | None = None
    # mesh axis that keeps the MoE expert dim sharded through dispatch ->
    # GEMM -> combine, so only the (B,S,D) partial sums cross shards
    moe_ep: str | None = None
    # the plain data-parallel axes of the mesh (for explicit reshards)
    dp: tuple | None = None
    # blockwise cross-entropy: compute the LM loss in vocab chunks of this
    # size, never materializing the full (tokens, V) logits
    ce_chunk: int | None = None


_POLICY: ShardingHints | None = None


def current() -> ShardingHints | None:
    return _POLICY


@contextmanager
def use_hints(policy: ShardingHints):
    global _POLICY
    prev = _POLICY
    _POLICY = policy
    try:
        yield policy
    finally:
        _POLICY = prev
