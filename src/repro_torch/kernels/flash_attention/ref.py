"""Plain PyTorch version of the paged flash-prefill kernel."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.ref import gather_kv
from repro_torch.models.layers import chunked_attention


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, q_offset,
                                kv_len):
    """Chunked-prefill attention over a paged KV cache.

    q: (B, C, H, D) -- a chunk of C query tokens whose first token sits at
    absolute position ``q_offset``; the chunk's own KV must already be
    written into the pages. Gathers the sequence's pages into a contiguous
    view and runs causal attention over the ``kv_len`` valid positions
    (cached prefix + this chunk). ``q_offset`` is an int; ``kv_len`` an int
    or (B,). Returns (B, C, H, D).
    """
    k = gather_kv(k_pages, block_tables)      # (B, S_ctx, KH, D)
    v = gather_kv(v_pages, block_tables)
    return chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                             kv_len=kv_len)
