"""Public wrappers for the paged decode kernels (``csrc/paged_attention.cu``).

Same signatures and layouts as the JAX package's
``repro/kernels/paged_attention/ops.py``: q is (B, H, D) with H = KH * G
query heads grouped over KH kv heads, pages are (NP, page_size, KH, D),
block tables (B, PPS), lengths (B,).

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain PyTorch version in ``ref.py``; CUDA tensors launch the hand-written
kernel or raise -- there is no fallback from a kernel to its plain
version. The wrapper checks device, dtype, shape and contiguity, allocates
the output, and launches on the current stream without synchronising.

The kernel splits each sequence's positions into blocks of
``SPLIT_POSITIONS`` and combines the splits' partial softmax states in a
float32 workspace, with one counter per (sequence, kv head, head group).
Workspace and counters are made once per (device, stream) and grown when a
call needs more (the counters are zeroed only then: every call leaves them
zero), so a call allocates nothing but its output. Several shards of a
tensor-parallel mesh on one card share that workspace: this is safe because
their calls run one after another on one stream (shards on separate
streams would need a workspace each).

Under a tensor-parallel mesh ``paged_attention_sharded`` and
``fused_decode_attention_sharded`` run the kernel once per shard, over the
shard's own pool (NP, page, KH/N, D) and its own query groups (B, G KH/N,
D): each kv head's attention is independent, so no collective is needed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    fused_decode_attention_ref, paged_attention_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
# positions per split: a multiple of the kernel's 64-position tile, at most
# 1024 (chosen on the card, PERF.md)
SPLIT_POSITIONS = 256
# (device index, stream) -> (float32 workspace, int32 counters)
_WORKSPACE: dict = {}
_ENTRIES: dict = {}


def _entry(name: str, n_ptr: int, n_int: int):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = _build.bind(_build.library("paged_attention"),
                                          name, n_ptr, n_int)
    return fn


def _workspace(dev, stream: int, B: int, H: int, D: int, n_pos: int):
    """The cached workspace and counters of ``dev`` / ``stream``, grown to
    hold B * H heads' partial states over ceil(n_pos / SPLIT_POSITIONS)
    splits."""
    n_ws = B * H * -(-n_pos // SPLIT_POSITIONS) * (D + 2)
    key = (dev.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_ws or ws[1].numel() < B * H:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = _WORKSPACE[key] = (
            torch.empty(max(n_ws, old[0]), dtype=torch.float32, device=dev),
            torch.zeros(max(B * H, old[1]), dtype=torch.int32, device=dev))
    return ws


def cached_workspace(dev, stream: int):
    """The workspace and counters cached for ``dev`` / ``stream``, or None
    before its first call. A CUDA graph that captured a launch on that
    stream holds them, so that a later call which grows them cannot free
    what the graph's launches point at."""
    return _WORKSPACE.get((dev.index, stream))


def _group(q, KH: int) -> int:
    H = q.shape[1]
    if H % KH:
        raise ValueError(
            f"query heads ({H}) must be a multiple of kv heads ({KH})")
    return H // KH


def _check(q, k_pages, v_pages, block_tables, context_lens, extra=()):
    """Validate what the CUDA kernel takes; returns (B, KH, G, D, page,
    PPS, dtype code)."""
    tensors = (q, k_pages, v_pages, block_tables, context_lens, *extra)
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the page pools must share one dtype")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block tables and lengths must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be (B, H, D), pages (NP, page, KH, D)")
    B, _, D = q.shape
    NP, page, KH, Dk = k_pages.shape
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (pages {Dk}); the kernel takes "
                         f"{HEAD_DIMS}")
    if page % 16:
        raise ValueError(f"page size {page} is not a multiple of 16")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or context_lens.shape != (B,):
        raise ValueError("block tables must be (B, PPS), lengths (B,)")
    G = _group(q, KH)
    return B, KH, G, D, page, block_tables.shape[1], _DTYPE_CODE[q.dtype]


def paged_attention(q, k_pages, v_pages, block_tables, context_lens):
    """Decode attention over a paged KV cache.

    q: (B, H, D) one query token per sequence; k_pages / v_pages:
    (NP, page_size, KH, D); block_tables: (B, PPS) int32 page ids (pad with
    0 beyond the length); context_lens: (B,) int32. Returns (B, H, D).
    """
    _group(q, k_pages.shape[2])
    _build.forbid_grad("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens)
    B, KH, G, D, page, pps, code = _check(q, k_pages, v_pages, block_tables,
                                          context_lens)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _workspace(q.device, stream, B, KH * G, D, pps * page)
    rc = _entry("paged_attention_fwd", 8, 8)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), B, KH, G, D, page, pps,
        SPLIT_POSITIONS, code, stream)
    _build.check("paged_attention", "paged_attention_fwd", rc)
    _build.LAUNCHES["paged_attention"] += 1
    return out


def fused_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                           k_tail, v_tail, tail_lens):
    """Decode attention over committed pages + an in-flight tail buffer.

    Position ``b`` attends pages ``[0, context_lens[b])`` plus tail rows
    ``[0, tail_lens[b])`` of k_tail/v_tail: (B, Kt, KH, D), under one
    softmax. Shapes otherwise as :func:`paged_attention`. Returns (B, H, D).
    """
    _group(q, k_pages.shape[2])
    _build.forbid_grad("fused_decode_attention", q, k_pages, v_pages, k_tail,
                       v_tail)
    if q.device.type == "cpu":
        return fused_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          context_lens, k_tail, v_tail,
                                          tail_lens)
    B, KH, G, D, page, pps, code = _check(
        q, k_pages, v_pages, block_tables, context_lens,
        extra=(k_tail, v_tail, tail_lens))
    if k_tail.dtype != q.dtype or v_tail.dtype != q.dtype \
            or tail_lens.dtype != torch.int32:
        raise TypeError("tails must share q's dtype; tail lengths int32")
    if k_tail.dim() != 4 or k_tail.shape != v_tail.shape \
            or k_tail.shape[0] != B or k_tail.shape[2:] != (KH, D) \
            or tail_lens.shape != (B,) or k_tail.shape[1] < 1:
        raise ValueError("tails must be (B, Kt >= 1, KH, D), lengths (B,)")
    out = torch.empty_like(q)
    kt_cap = k_tail.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _workspace(q.device, stream, B, KH * G, D,
                              pps * page + kt_cap)
    rc = _entry("paged_decode_tail_fwd", 11, 9)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), k_tail.data_ptr(),
        v_tail.data_ptr(), tail_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), B, KH, G, D, page, pps, kt_cap,
        SPLIT_POSITIONS, code, stream)
    _build.check("paged_attention", "paged_decode_tail_fwd", rc)
    _build.LAUNCHES["fused_decode_attention"] += 1
    return out


# -- tensor-parallel entries -------------------------------------------------
# Every argument is a list over the shards, each entry on its shard's
# device: q, pages and tails split over the kv heads (shard s holds kv heads
# [s KH/N, (s+1) KH/N) and their query groups), tables and lengths
# replicated. Requires KH % N == 0 (the caller serves other head counts by
# the plain head_dim-split path).


def shardable_kv_heads(num_kv_heads: int, mesh, axis: str = "model") -> bool:
    return mesh is not None and num_kv_heads % mesh.shape[axis] == 0


def paged_attention_sharded(qs, k_pages, v_pages, block_tables,
                            context_lens):
    """:func:`paged_attention` on each shard; returns the per-shard
    (B, H/N, D) outputs."""
    return [paged_attention(*a) for a in zip(qs, k_pages, v_pages,
                                              block_tables, context_lens)]


def fused_decode_attention_sharded(qs, k_pages, v_pages, block_tables,
                                   context_lens, k_tails, v_tails,
                                   tail_lens):
    """:func:`fused_decode_attention` on each shard (tails split over the
    kv heads too); returns the per-shard (B, H/N, D) outputs."""
    return [fused_decode_attention(*a) for a in zip(
        qs, k_pages, v_pages, block_tables, context_lens, k_tails, v_tails,
        tail_lens)]
