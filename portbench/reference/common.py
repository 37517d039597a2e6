"""Layers the family references share, in plain float32 PyTorch.

Every layer takes a precision: ``float32`` (the reference) or ``fp8`` (the
control: the program's bf16 activations, rounded after every step as the
program stores them, with each weight product one step further down, its
weight quantised to float8 e4m3 per output column and its input per row:
the fp8 products a later change to the program could be tempted to take).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact():
    """Float32 products in float32: TF32 off for the block, as it was
    before."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def fp8_round(x, dim: int):
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to the format's largest)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def act(x, precision: str):
    """An activation as the precision stores it: float32, or rounded to
    bf16 (``fp8``: the program's activations)."""
    if precision == "fp8":
        return x.to(torch.bfloat16).float()
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x


def linear(x, w, precision: str = "float32"):
    """x (..., in) @ w (in, out) in float32, or through float8 (``fp8``)."""
    w = w.float()
    if precision == "fp8":
        return act(fp8_round(x, -1) @ fp8_round(w, 0), precision)
    return act(x @ w, precision)


def rms_norm(x, w, eps, precision: str = "float32"):
    return act(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
               * w.float(), precision)


def rope(x, theta):
    """x (S, heads, D) at positions 0..S-1; rotates interleaved pairs (2i,
    2i+1), frequency theta^(-i / (D/2))."""
    S, _, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def causal_attention(q, k, v, block: int = 512):
    """Softmax attention of q (S, H, D) over k, v (S, KH, D), each query
    seeing its own and earlier positions; H a multiple of KH (grouped
    queries). Queries a block at a time."""
    S, H, D = q.shape
    KH = k.shape[1]
    qh = q.reshape(S, KH, H // KH, D).permute(1, 2, 0, 3)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = torch.einsum("hgqd,hkd->hgqk", qh[:, :, s0:s1], kh[:, :s1])
        sc = sc / math.sqrt(D)
        sc = sc.masked_fill(pos[None, :s1] > pos[s0:s1, None], -math.inf)
        o = torch.einsum("hgqk,hkd->hgqd", torch.softmax(sc, -1), vh[:, :s1])
        out[s0:s1] = o.permute(2, 0, 1, 3).reshape(s1 - s0, H, D)
    return out


def attention_block(h, norm_w, aw, m, precision):
    """Pre-norm self-attention sublayer's output (to be added to h):
    projections, RoPE, causal attention, output projection."""
    S = h.shape[0]
    H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    x = rms_norm(h, norm_w, m["norm_eps"], precision)
    q = linear(x, aw["wq"], precision).reshape(S, H, hd)
    k = linear(x, aw["wk"], precision).reshape(S, KH, hd)
    v = linear(x, aw["wv"], precision).reshape(S, KH, hd)
    q = act(rope(q, m["rope_theta"]), precision)
    k = act(rope(k, m["rope_theta"]), precision)
    a = act(causal_attention(q, k, v), precision)
    return linear(a.reshape(S, H * hd), aw["wo"], precision)


def swiglu(x, w1, w3, w2, precision):
    h = act(F.silu(linear(x, w1, precision)) * linear(x, w3, precision),
            precision)
    return linear(h, w2, precision)


def head_logits(h, final_norm, lm_head, m, precision):
    return linear(rms_norm(h, final_norm, m["norm_eps"], precision), lm_head,
                  precision)
