"""Plain PyTorch for the slot decode attention kernel.

The kernel's plain version is :func:`repro_torch.models.layers.
decode_attention_appended` itself, which ``ops.slot_decode_attention``
runs for CPU tensors. :func:`split_slot_decode_ref` models the kernel's
split-K schedule, for the tests.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import NEG_INF


def split_slot_decode_ref(q, k_cache, v_cache, k_new, v_new, prev_len, *,
                          window=0, scale=None, split):
    """Plain model of the CUDA kernel's split-K schedule.

    Slot b's positions are the cache rows ``[lo, ctx)`` and then the new
    token, with ``ctx = min(prev_len, Smax)`` and ``lo`` the first position
    the window keeps (``prev_len - pos < window``; 0 without a window, at
    most ``ctx``). The ``Smax + 1`` positions a slot can have are cut into
    splits of ``split``; each split forms its own ``(m, l, acc)`` --
    ``m = NEG_INF`` and ``l = 0`` where it holds no position -- and the
    splits are combined with weights ``exp(m_s - M)``, a split with
    ``l = 0`` weighing nothing. Shapes as ``decode_attention_appended``,
    which it equals up to float32 rounding.
    """
    B, _, H, D = q.shape
    KH, Smax = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    n = prev_len.long().clamp(min=0)
    ctx = n.clamp(max=Smax)
    lo = torch.minimum((n - window + 1).clamp(min=0), ctx) if window \
        else torch.zeros_like(ctx)
    total = ctx - lo + 1
    nsplit = -(-(Smax + 1) // split)
    i = torch.arange(nsplit * split, device=q.device)[None, :]
    valid = i < total[:, None]                               # (B, P)
    # row of [cache ; new token] that holds each position of the slot
    row = torch.where(i == (total - 1)[:, None], Smax,
                      torch.where(valid, lo[:, None] + i, 0))
    idx = row[:, None, :, None].expand(B, KH, -1, D)
    k = torch.cat([k_cache, k_new[:, :, None]], 2).gather(2, idx).float()
    v = torch.cat([v_cache, v_new[:, :, None]], 2).gather(2, idx).float()
    qr = q.reshape(B, KH, H // KH, D).float() * scale
    s = torch.einsum("bhgd,bhpd->bhgp", qr, k)
    s = s.reshape(*s.shape[:3], nsplit, split)
    ok = valid.reshape(B, 1, 1, nsplit, split)
    m = torch.where(ok, s, NEG_INF).amax(-1)                # (B, KH, G, n)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgnk,bhnkd->bhgnd", p,
                       v.reshape(B, KH, nsplit, split, D))
    w = torch.where(l > 0, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    out = (acc * w[..., None]).sum(-2) \
        / torch.clamp((l * w).sum(-1), min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
