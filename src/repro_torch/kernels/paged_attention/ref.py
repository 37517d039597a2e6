"""Plain PyTorch versions of the paged decode kernels.

They follow the KERNELS' semantics: scores in float32, masked positions
contribute nothing, and the result is ``acc / max(l, 1e-30)`` -- so a row
with no valid position (empty context and empty tail) is zeros. (The JAX
package's jnp oracle ``paged_attention_ref`` softmaxes such a row to a
uniform average instead; its Pallas kernels, which these mirror, give
zeros.) The CPU path of every wrapper in ``ops.py`` runs these, and the
card checks hold the CUDA kernels against them. ``split_decode_attention_ref``
models the CUDA kernel's split-K schedule for the tests; no wrapper runs it.
The ``*_sharded_ref`` entries take lists over the shards of a
tensor-parallel mesh, as the ``ops`` sharded entries do.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_kv(pages, block_tables):
    """pages: (NP, page, KH, D); block_tables: (B, PPS) ->
    (B, PPS*page, KH, D)."""
    g = pages[block_tables.long()]                   # (B, PPS, page, KH, D)
    B, PPS, page, KH, D = g.shape
    return g.reshape(B, PPS * page, KH, D)


def _masked_attention(qr, segments):
    """qr: (B, KH, G, D) float32, already scaled. segments: list of
    (k (B, S, KH, D), v, valid (B, S) bool). One softmax over all
    segments' valid positions; zeros where none is valid."""
    scores = [torch.einsum("bhgd,bkhd->bhgk", qr, k.float())
              for k, _, _ in segments]
    masks = [valid[:, None, None, :] for _, _, valid in segments]
    s = torch.cat([torch.where(mk, sc, NEG_INF)
                   for sc, mk in zip(scores, masks)], dim=-1)
    mask = torch.cat([mk.expand_as(sc) for sc, mk in zip(scores, masks)],
                     dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out, s0 = 0.0, 0
    for k, v, _ in segments:
        n = k.shape[1]
        out = out + torch.einsum("bhgk,bkhd->bhgd", p[..., s0:s0 + n],
                                 v.float())
        s0 += n
    return out / torch.clamp(l, min=1e-30)


def decode_tail_attention_ref(q, k_ctx, v_ctx, context_lens, k_tail, v_tail,
                              tail_lens):
    """Decode attention over a contiguous committed context plus an
    in-flight tail, under one softmax.

    q: (B, H, D); k_ctx/v_ctx: (B, S, KH, D) (``[0, context_lens[b])``
    valid); k_tail/v_tail: (B, Kt, KH, D) (``[0, tail_lens[b])`` valid).
    Equals attention over the contiguous positions
    ``[0, context_lens[b] + tail_lens[b])``. Returns (B, H, D).
    """
    B, H, D = q.shape
    KH = k_ctx.shape[2]
    qr = q.reshape(B, KH, H // KH, D).float() * (1.0 / math.sqrt(D))
    dev = q.device
    ctx_ok = torch.arange(k_ctx.shape[1], device=dev)[None, :] \
        < context_lens.long()[:, None]
    tail_ok = torch.arange(k_tail.shape[1], device=dev)[None, :] \
        < tail_lens.long()[:, None]
    out = _masked_attention(qr, [(k_ctx, v_ctx, ctx_ok),
                                 (k_tail, v_tail, tail_ok)])
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens):
    """Single-token decode attention over a paged KV cache.
    q: (B, H, D); pages: (NP, page, KH, D); block_tables: (B, PPS);
    context_lens: (B,). Returns (B, H, D)."""
    B, H, D = q.shape
    KH = k_pages.shape[2]
    k = gather_kv(k_pages, block_tables)
    v = gather_kv(v_pages, block_tables)
    qr = q.reshape(B, KH, H // KH, D).float() * (1.0 / math.sqrt(D))
    ok = torch.arange(k.shape[1], device=q.device)[None, :] \
        < context_lens.long()[:, None]
    return _masked_attention(qr, [(k, v, ok)]).reshape(B, H, D).to(q.dtype)


def fused_decode_attention_ref(q, k_pages, v_pages, block_tables,
                               context_lens, k_tail, v_tail, tail_lens):
    """Plain version of the fused decode-tail kernel: gather pages, then
    split attention. Same signature as ``ops.fused_decode_attention``."""
    return decode_tail_attention_ref(
        q, gather_kv(k_pages, block_tables), gather_kv(v_pages, block_tables),
        context_lens, k_tail, v_tail, tail_lens)


def paged_attention_sharded_ref(qs, k_pages, v_pages, block_tables,
                                context_lens):
    """:func:`paged_attention_ref` on each shard (lists over the shards,
    split over the kv heads); returns the per-shard outputs."""
    return [paged_attention_ref(*a) for a in zip(qs, k_pages, v_pages,
                                                  block_tables, context_lens)]


def fused_decode_attention_sharded_ref(qs, k_pages, v_pages, block_tables,
                                       context_lens, k_tails, v_tails,
                                       tail_lens):
    """:func:`fused_decode_attention_ref` on each shard; returns the
    per-shard outputs."""
    return [fused_decode_attention_ref(*a) for a in zip(
        qs, k_pages, v_pages, block_tables, context_lens, k_tails, v_tails,
        tail_lens)]


def split_decode_attention_ref(q, k_pages, v_pages, block_tables,
                               context_lens, k_tail=None, v_tail=None,
                               tail_lens=None, *, split):
    """Plain model of the CUDA kernel's split-K schedule, for the tests.

    The sequence is positions ``[0, ctx)`` of the pages then ``[0, tl)`` of
    the tail (none without one); the host-known bound
    ``PPS * page + Kt`` is cut into splits of ``split`` positions. Each
    split forms its own ``(m, l, acc)`` -- ``m = NEG_INF`` and ``l = 0``
    where it holds no valid position -- and the splits are combined with
    weights ``exp(m_s - M)``, a split with ``l = 0`` weighing nothing.
    Equals :func:`fused_decode_attention_ref` (with a tail) or
    :func:`paged_attention_ref` (without) up to float32 rounding.
    """
    B, H, D = q.shape
    KH = k_pages.shape[2]
    k_ctx = gather_kv(k_pages, block_tables)
    v_ctx = gather_kv(v_pages, block_tables)
    n_ctx = k_ctx.shape[1]
    if k_tail is None:
        k_tail = v_tail = k_ctx[:, :0]
        tail_lens = torch.zeros_like(context_lens)
    kt_cap = k_tail.shape[1]
    ctx = context_lens.long().clamp(max=n_ctx)
    tl = tail_lens.long().clamp(max=kt_cap)
    nsplit = -(-(n_ctx + kt_cap) // split)
    pos = torch.arange(nsplit * split, device=q.device)[None, :]
    valid = pos < (ctx + tl)[:, None]                       # (B, P)
    # row of [context ; tail] that holds each position of the sequence
    row = torch.where(pos < ctx[:, None], pos, n_ctx + pos - ctx[:, None])
    row = torch.where(valid, row, 0)
    idx = row[:, :, None, None].expand(-1, -1, KH, D)
    k = torch.cat([k_ctx, k_tail], 1).gather(1, idx).float()
    v = torch.cat([v_ctx, v_tail], 1).gather(1, idx).float()
    qr = q.reshape(B, KH, H // KH, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bphd->bhgp", qr, k)
    s = s.reshape(*s.shape[:3], nsplit, split)
    ok = valid.reshape(B, 1, 1, nsplit, split)
    m = torch.where(ok, s, NEG_INF).amax(-1)                # (B, KH, G, n)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgnk,bnkhd->bhgnd", p,
                       v.reshape(B, nsplit, split, KH, D))
    w = torch.where(l > 0, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    out = (acc * w[..., None]).sum(-2) \
        / torch.clamp((l * w).sum(-1), min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
