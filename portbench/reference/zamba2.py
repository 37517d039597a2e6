"""Plain float32 reference of the ``zamba2`` family, the port's ``hybrid``
at the published Zamba2 layout (``transformers``' ``modeling_zamba2.py``,
read as equations), with e the token embeddings and x the stream, for each
layer l:

* at the j-th hybrid id, with tied block b = j mod ``num_mem_blocks``:
  u = rmsnorm_b([x, e]) (width 2 d); q, k, v = u W_{q,k,v}, heads of
  ``head_dim`` rotated by rotate-half RoPE; causal softmax attention at
  scale (head_dim / 2)^-0.5; a = o W_o; g = rmsnorm'_b(a); gate, up = chunk(g W_gu +
  g A_j B_j, 2); T = ((gelu(gate) * up) W_down) W_lin,j;
* x <- x + Mamba2_l(rmsnorm_l(x + T)) (T = 0 elsewhere): in_proj to z, the
  conv input and dt; a causal depthwise conv with bias and SiLU; dt =
  softplus(dt + dt_bias); the SSD scan with B and C in groups (head i reads
  group i // (heads / groups)) and the D skip; y * silu(z) normed per group;
  out_proj.

Then the final norm and the head (the embedding's transpose where tied).
The scan here is a chunked float32 scan of its own (``ssd_scan``). The
sequences' tokens go through every projection together, layer-major, so
that each weight is read once a call; the conv, the scan and the attention
run one sequence at a time. The configuration
file lists where this and the program depart from the published code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import act, exact, head_logits, linear, rms_norm

SCAN_CHUNK = 64


def rope_half(x, theta):
    """x (S, heads, D) at positions 0..S-1; rotates (i, i + D/2) by
    theta^(-i / (D/2))."""
    S, _, D = x.shape
    n = D // 2
    freqs = theta ** (-torch.arange(n, dtype=torch.float32,
                                    device=x.device) / n)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :n], x[..., n:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, scale, block: int = 512):
    """Causal softmax attention of q (S, H, D) over k, v (S, KH, D) at
    ``scale``, queries a block at a time."""
    S, H, D = q.shape
    KH = k.shape[1]
    qh = q.reshape(S, KH, H // KH, D).permute(1, 2, 0, 3)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = torch.einsum("hgqd,hkd->hgqk", qh[:, :, s0:s1], kh[:, :s1]) * scale
        sc = sc.masked_fill(pos[None, :s1] > pos[s0:s1, None], -math.inf)
        o = torch.einsum("hgqk,hkd->hgqd", torch.softmax(sc, -1), vh[:, :s1])
        out[s0:s1] = o.permute(2, 0, 1, 3).reshape(s1 - s0, H, D)
    return out


def ssd_scan(x, dt, A, B, C, chunk: int = SCAN_CHUNK):
    """y (S, h, P) of the selective scan from a zero state: h_t =
    exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, per head with its
    group's B and C. x (S, h, P), dt (S, h), A (h,), B and C (S, G, N).
    Chunked: within a chunk the quadratic form, across chunks the state."""
    S, h, P = x.shape
    G, N = B.shape[1:]
    Bh = B.repeat_interleave(h // G, dim=1)                  # (S, h, N)
    Ch = C.repeat_interleave(h // G, dim=1)
    a = dt * A                                               # (S, h)
    xd = x * dt[..., None]
    pad = -S % chunk
    if pad:
        xd, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xd, Bh, Ch))
        a = F.pad(a, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xd = xd.reshape(nc, chunk, h, P)
    Bh, Ch = Bh.reshape(nc, chunk, h, N), Ch.reshape(nc, chunk, h, N)
    acs = torch.cumsum(a.reshape(nc, chunk, h), dim=1)       # (c, i, h)
    seg = acs[:, :, None, :] - acs[:, None, :, :]            # (c, i, j, h)
    i = torch.arange(chunk, device=x.device)
    lower = (i[:, None] >= i[None, :])[None, :, :, None]
    W = torch.einsum("cihn,cjhn->cijh", Ch, Bh) \
        * torch.exp(torch.where(lower, seg, -math.inf))
    y = torch.einsum("cijh,cjhp->cihp", W, xd)
    # each chunk's own contribution to the state at its end
    local = torch.einsum("cjh,cjhp,cjhn->chpn",
                         torch.exp(acs[:, -1:, :] - acs), xd, Bh)
    state = torch.zeros((h, P, N), dtype=torch.float32, device=x.device)
    for c in range(nc):
        y[c] += torch.exp(acs[c])[..., None] \
            * torch.einsum("ihn,hpn->ihp", Ch[c], state)
        state = torch.exp(acs[c, -1])[:, None, None] * state + local[c]
    return y.reshape(nc * chunk, h, P)[:S]


def mixer(xs, w, m, precision):
    """One Mamba2 mixer over the sequences ``xs`` (each (S, d), normed):
    the projections over all their tokens at once, the conv and the scan
    one sequence at a time."""
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    G, N, P = s.get("n_groups", 1), s["d_state"], s["head_dim"]
    h, K = di // P, s["conv_kernel"]
    sizes = [x.shape[0] for x in xs]
    cw = w["conv_w"].float()                                 # (K, ch)
    A = -torch.exp(w["A_log"].float())
    gated = []
    for zxbcdt in linear(torch.cat(xs), w["in_proj"], precision).split(sizes):
        S = zxbcdt.shape[0]
        z, xbc, dt = zxbcdt.split([di, di + 2 * G * N, h], dim=-1)
        xp = F.pad(xbc, (0, 0, K - 1, 0))
        conv = sum(xp[k:k + S] * cw[k] for k in range(K)) \
            + w["conv_b"].float()
        xbc = act(F.silu(conv), precision)
        xc, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
        dt = F.softplus(dt + w["dt_bias"].float())
        xc = xc.reshape(S, h, P)
        y = ssd_scan(xc, dt, A, Bm.reshape(S, G, N), Cm.reshape(S, G, N))
        y = act(y + w["D"].float()[:, None] * xc, precision).reshape(S, di)
        g = (y * F.silu(z)).reshape(S, G, di // G)
        gated.append(act(
            g * torch.rsqrt(g.square().mean(-1, keepdim=True)
                            + m["norm_eps"])
            * w["norm"].float().reshape(G, di // G), precision
        ).reshape(S, di))
    return linear(torch.cat(gated), w["out_proj"], precision).split(sizes)


def tied_block(hs, es, bw, aw, m, precision):
    """One application of a tied block (weights ``bw``) with its adapter
    and linear (``aw``) to the sequences ``hs`` with embeddings ``es``:
    each its T (S, d). The projections run over all the tokens at once,
    the attention one sequence at a time."""
    H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    sizes = [h.shape[0] for h in hs]
    u = rms_norm(torch.cat([torch.cat(hs), torch.cat(es)], -1), bw["norm1"],
                 m["norm_eps"], precision)
    q, k, v = (linear(u, bw["attn"][n], precision).split(sizes)
               for n in ("wq", "wk", "wv"))
    scale = (hd / 2) ** -0.5
    att = []
    for qs, ks, vs in zip(q, k, v):
        S = qs.shape[0]
        qs = act(rope_half(qs.reshape(S, H, hd), m["rope_theta"]), precision)
        ks = act(rope_half(ks.reshape(S, KH, hd), m["rope_theta"]), precision)
        att.append(act(attention(qs, ks, vs.reshape(S, KH, hd), scale),
                       precision).reshape(S, H * hd))
    g = rms_norm(linear(torch.cat(att), bw["attn"]["wo"], precision),
                 bw["norm2"], m["norm_eps"], precision)
    gu = linear(g, bw["mlp"]["gate_up"], precision) + linear(
        linear(g, aw["adapter_in"], precision), aw["adapter_out"], precision)
    gate, up = gu.chunk(2, dim=-1)
    t = linear(act(F.gelu(gate) * up, precision), bw["mlp"]["down"],
               precision)
    return linear(t, aw["linear"], precision).split(sizes)


def logits(params, m: dict, seqs, precision: str = "float32"):
    """``seqs``: (token ids, first) pairs. Returns for each the float32
    logits (len - first, V) of positions first..len-1, the prediction of
    each next token."""
    P = params["layers"]
    dev = params["embed"].device
    app = {i: j for j, i in enumerate(m["hybrid_layer_ids"])}
    nb = m["num_mem_blocks"]

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    with exact():
        es = [act(params["embed"][torch.as_tensor(t, device=dev)].float(),
                  precision) for t, _ in seqs]
        hs = list(es)
        for i in range(m["num_layers"]):
            xs = hs
            if i in app:
                j = app[i]
                ts = tied_block(hs, es, take(params["blocks"], j % nb),
                                take(params["apps"], j), m, precision)
                xs = [act(h + t, precision) for h, t in zip(hs, ts)]
            xs = [rms_norm(x, P["norm"][i], m["norm_eps"], precision)
                  for x in xs]
            ys = mixer(xs, take(P["mamba"], i), m, precision)
            hs = [act(h + y, precision) for h, y in zip(hs, ys)]
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        return [head_logits(h[first:], params["final_norm"], head, m,
                            precision) for h, (_, first) in zip(hs, seqs)]
