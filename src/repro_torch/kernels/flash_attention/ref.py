"""Plain PyTorch versions of the flash-attention kernels, and the full
softmax oracle ``attention_ref``.

The dense kernel's plain version is :func:`repro_torch.models.layers.
chunked_attention` itself (start-aligned positions, as the kernel's), which
``ops.flash_attention`` runs for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention.ref import NEG_INF, gather_kv
from repro_torch.models.layers import chunked_attention


def attention_ref(q, k, v, *, causal=True, window=0, kv_len=None):
    """Full-softmax attention, the port of the JAX package's oracle
    (``repro/kernels/flash_attention/ref.py``). q: (B, Sq, H, D); k, v:
    (B, Sk, KH, D). Query positions are END-aligned (row i sits at
    i + Sk - Sq, decode-style); the flash kernel's are start-aligned, so
    the two agree when Sq == Sk. Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qr = q.reshape(B, Sq, KH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * (1.0 / math.sqrt(D))
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & ((qpos - kpos) < window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


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
