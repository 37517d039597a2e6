"""Shared neural building blocks: norms, RoPE, attention, SwiGLU MLP, and
parameter initializers (the port of ``repro/models/layers.py``).

Plain functions on tensors over nested-dict parameters. Weights keep the
reference's ``(in, out)`` layout and are applied as ``x @ w``, so a bridged
JAX parameter tree needs no transposes. Activations are computed in the
dtype of the inputs; norms, RoPE and attention scores in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as _hints

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, scale=None,
               dtype=torch.float32):
    """Truncated normal in [-2, 2] times ``scale`` (default
    ``1/sqrt(fan_in)``, fan_in = ``shape[-2]``), on the generator's device.
    Same shapes and scales as the reference; the values come from the torch
    generator, so they are not the reference's bits."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def dense_init_stacked(generator: torch.Generator, shape, scale=None,
                       dtype=torch.float32):
    """:func:`dense_init` for a stack on a leading layer axis, drawn one
    layer at a time into a preallocated tensor of ``dtype``: the float32
    draw and its in-place scaling take one layer's room, not the whole
    stack's (an MoE expert stack is tens of GB at serving width)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        w = torch.empty(shape[1:], dtype=torch.float32,
                        device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out[i] = w.mul_(scale)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-5):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE: interleaved pairs (2i, 2i+1) rotate together -- NOT the half-split
# rotation most PyTorch code uses; it must match the reference bit layout.
# ``half`` rotates (i, i + D/2) instead (rotate-half, Zamba2's shared block)
# ---------------------------------------------------------------------------

def rope(x, positions, theta=10000.0, half=False):
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    n = d // 2
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    freqs = theta ** (-idx / n)                                   # (n,)
    ang = positions.float()[..., None] * freqs                    # (..., S, n)
    cos = torch.cos(ang)[..., None, :]                            # (..., S, 1, n)
    sin = torch.sin(ang)[..., None, :]
    if half:
        x1, x2 = x[..., :n].float(), x[..., n:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain PyTorch)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_len=None, q_chunk=512, scale=None):
    """Masked softmax attention, one block of ``q_chunk`` queries at a time.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 (GQA).
    ``q_offset``: absolute position of q[0] (chunked prefill);
    ``kv_len``: (B,) tensor or int of valid kv positions (padded cache);
    ``window``: sliding-window size (0 = unlimited); ``scale``: the
    softmax scale (default 1/sqrt(D)). Scores in float32; probabilities
    are cast to v's dtype before the PV product and accumulated in
    float32, as the reference does. A row with
    no visible key is zeros, as in the flash kernel (the reference's
    online softmax averages such a row; no model path has one). Returns
    (B, Sq, H, D) in q's dtype.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev = q.device
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Sk, device=dev)
    if kv_len is None:
        lens = torch.full((B,), Sk, device=dev)
    else:
        lens = torch.as_tensor(kv_len, device=dev).expand(B)
    valid = (kpos[None, :] < lens[:, None])[:, None, None, None, :]
    outs = []
    for s0 in range(0, Sq, q_chunk):
        c = min(q_chunk, Sq - s0)
        qb = q[:, s0:s0 + c].reshape(B, c, KH, G, D).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf) * scale
        mask = valid
        qpos = q_offset + s0 + torch.arange(c, device=dev)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vf)
        o = o / torch.clamp(l, min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, c, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention_appended(q, k_cache, v_cache, k_new, v_new, *,
                              prev_len, window=0, scale=None):
    """Single-token attention over (existing cache) + (the new token's kv),
    without writing the new kv into the cache first.

    q: (B, 1, H, D); caches: (B, KH, Smax, D) kv-heads-major;
    k_new/v_new: (B, KH, D); prev_len: (B,) valid positions before this
    token; ``window``: sliding-window size (0 = unlimited); ``scale``: the
    softmax scale (default 1/sqrt(D)). Returns (B, 1, H, D).
    """
    B, _, H, D = q.shape
    KH, Smax = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qr = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qr, k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    mask = pos[None, :] < prev_len[:, None]
    if window:
        mask = mask & (prev_len[:, None] - pos[None, :] < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    s_new = torch.einsum("bhgd,bhd->bhg", qr, k_new.float()) * scale
    m = torch.maximum(s.amax(dim=-1), s_new)
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p.sum(dim=-1) + p_new
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + p_new[..., None] * v_new[:, :, None, :].float()
    out = out / denom[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def head_dim_split_attention(qs, ks, vs, valid, reduce):
    """Attention whose head_dim is split over shards (tensor parallelism
    where the kv heads do not divide the shards).

    qs[s]: (B, T, H, d_s) and ks[s] / vs[s]: (B, S, KH, d_s), shard s's
    slice of head_dim, on its device; ``valid``: (B, T, S) bool, which keys
    query t sees; ``reduce(partials)``: their sum, on the lead device. Each
    shard's partial float32 q.k^T is summed by ``reduce`` and scaled by
    1/sqrt(sum d_s), one softmax runs on the lead device (a row with no
    valid key is zeros), and each shard forms its own d_s slice of the
    output. Returns per-shard (B, T, H, d_s) in q's dtype."""
    B, T, H, _ = qs[0].shape
    KH = ks[0].shape[2]
    D = sum(q.shape[-1] for q in qs)
    parts = [torch.einsum("btkgd,bskd->bkgts",
                          q.reshape(B, T, KH, H // KH, -1).float(), k.float())
             for q, k in zip(qs, ks)]
    s = reduce(parts) * (1.0 / math.sqrt(D))
    mask = valid[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return [torch.einsum("bkgts,bskd->btkgd", p.to(v.device), v.float())
            .reshape(B, T, H, -1).to(q.dtype) for q, v in zip(qs, vs)]


# ---------------------------------------------------------------------------
# attention layer: projections + rope
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, dtype, num_stacked):
    """Attention weights stacked on a leading layer axis of
    ``num_stacked``."""
    d, qd, kvd, L = cfg.d_model, cfg.q_dim, cfg.kv_dim, num_stacked
    p = {
        "wq": dense_init(generator, (L, d, qd), dtype=dtype),
        "wk": dense_init(generator, (L, d, kvd), dtype=dtype),
        "wv": dense_init(generator, (L, d, kvd), dtype=dtype),
        "wo": dense_init(generator, (L, qd, d),
                         scale=1.0 / math.sqrt(qd * 2 * cfg.num_layers),
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((L, qd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((L, kvd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((L, kvd), dtype=dtype, device=dev)
    return p


def project_qkv(x, p, cfg, positions):
    """QKV projections + RoPE. x: (B, S, D) ->
    q (B,S,H,hd), k (B,S,KH,hd), v (B,S,KH,hd)."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return split_heads_rope(q, k, v, cfg, positions)


def split_heads_rope(q, k, v, cfg, positions):
    """(B, S, H*hd) / (B, S, KH*hd) projections -> q (B,S,H,hd), k and v
    (B,S,KH,hd), with RoPE on q and k (decoders)."""
    B, S, _ = q.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KH, hd)
    v = v.reshape(B, S, KH, hd)
    if cfg.causal or not cfg.is_encoder:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_half)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_half)
    return q, k, v


def attention_layer(x, p, cfg, *, positions, cache=None, cache_index=None,
                    window=0, return_kv=False, use_kernel=False):
    """x: (B, S, D). Without a cache (prefill): causal self-attention, and
    with ``return_kv`` the second result is the rope'd (k, v) pair;
    ``use_kernel`` runs it through the flash kernel's wrapper. With a
    cache (decode, S == 1): cache = dict(k, v) of (B, KH, Smax, hd) and
    cache_index (B,) lengths before this token; the second result is the
    new token's (k, v) vectors, for the caller to write once. ``window``:
    sliding-window size (0 = unlimited)."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = project_qkv(x, p, cfg, positions)
    if cache is None:
        if use_kernel:
            # the wrapper's module imports this one for its plain version
            from repro_torch.kernels.flash_attention.ops import \
                flash_attention as attend
        else:
            attend = chunked_attention
        hp = _hints.current()
        if hp is not None and hp.attn_dp is not None:
            # the batch over (data x model) for the attention, where the
            # heads do not divide the model axis (the reference's hint)
            q = _hints.constrain_batch(q, hp.attn_dp)
            k = _hints.constrain_batch(k, hp.attn_dp)
            v = _hints.constrain_batch(v, hp.attn_dp)
        out = attend(q, k, v, causal=cfg.causal, window=window,
                     scale=cfg.attn_scale)
        if hp is not None and hp.attn_dp is not None:
            out = _hints.constrain_batch(out, hp.batch_axes)
        new_cache = (k, v) if return_kv else None
    else:
        out = decode_attention_appended(q, cache["k"], cache["v"], k[:, 0],
                                        v[:, 0], prev_len=cache_index,
                                        window=window,
                                        scale=cfg.attn_scale)
        new_cache = (k[:, 0], v[:, 0])
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model, d_ff, num_layers, dtype, num_stacked):
    L = num_stacked
    return {
        "w1": dense_init(generator, (L, d_model, d_ff), dtype=dtype),
        "w3": dense_init(generator, (L, d_model, d_ff), dtype=dtype),
        "w2": dense_init(generator, (L, d_ff, d_model),
                         scale=1.0 / math.sqrt(d_ff * 2 * num_layers),
                         dtype=dtype),
    }


def mlp_layer(x, p):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def gated_gelu_mlp(x, p, adapter=None):
    """Zamba2's MLP: gate and up from one (d, 2f) ``gate_up`` product (plus
    the low-rank ``adapter`` (A (d, r), B (r, 2f)) where given), then
    gelu(gate) * up through ``down`` (f, d)."""
    gu = x @ p["gate_up"]
    if adapter is not None:
        gu = gu + (x @ adapter[0]) @ adapter[1]
    gate, up = gu.chunk(2, dim=-1)
    return (F.gelu(gate) * up) @ p["down"]
