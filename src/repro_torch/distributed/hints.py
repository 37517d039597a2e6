"""Activation hints read inside model code (the port of
``repro/distributed/hints.py``).

The default is OFF (no policy). A caller opts in with
``use_hints(ShardingHints(...))`` around a call. On one device the only
hint that changes what runs is ``ce_chunk``: ``LM.train_loss`` then
computes the LM loss in vocab chunks of that size (``_chunked_ce``), never
materializing the full (tokens, V) logits.

The mesh hints (``attn_dp``, ``batch_axes``, ``moe_ep``, ``dp``) are read
at the reference's call sites in the model code: the full-sequence
attention of ``models/layers.py`` (q, k and v under ``attn_dp``, its output
under ``batch_axes``) and the grouped expert combine of ``models/moe.py``
(the expert outputs under ``moe_ep``). The reference's ``constrain`` and
``constrain_batch`` insert GSPMD sharding constraints there; the port runs
explicit programs and has no GSPMD, so its two functions return ``x``
unchanged. Inside the dry run's step analysis
(``launch/step_analysis.py``, which installs itself with
:func:`recording`) they also tell it of the reshard: its collective bytes
and the batch split the attention then runs at on one shard.
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
_RECORDER = None        # the active step analysis, or None


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


@contextmanager
def recording(recorder):
    """Route :func:`constrain` and :func:`constrain_batch` to
    ``recorder.reshard(x, spec_axes, kind)`` for the duration."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = recorder
    try:
        yield recorder
    finally:
        _RECORDER = prev


def constrain(x, spec_axes):
    """``x`` placed at the per-dimension axes ``spec_axes`` (a mesh axis, a
    tuple of axes or None per dimension). Returns ``x`` unchanged; a step
    analysis records the reshard as an all-gather (the reference's one
    caller replicates the expert dimension before a shard-local gather)."""
    if _RECORDER is not None:
        _RECORDER.reshard(x, tuple(spec_axes), "all-gather")
    return x


def constrain_batch(x, axes):
    """``x`` with its batch dimension over ``axes`` (the rest whole), or
    ``x`` as it is when ``axes`` is None. Returns ``x`` unchanged; a step
    analysis records the reshard as an all-to-all."""
    if axes is not None and _RECORDER is not None:
        _RECORDER.reshard(x, (axes,) + (None,) * (x.dim() - 1), "all-to-all")
    return x
