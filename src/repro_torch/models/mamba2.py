"""Mamba2 mixer with the SSD (state-space duality) chunked scan (the port of
``repro/models/mamba2.py``) [arXiv:2405.21060].

``ssd_chunked`` here is the plain PyTorch scan and the SSD kernel's plain
version (``kernels/ssd/ref.py`` re-exports it); ``csrc/ssd.cu`` computes the
same math on the card. ``mamba_layer(..., use_kernel=True)`` sends its
prefill scan through the kernel's wrapper ``kernels.ssd.ops.ssd``, and its
decode step between the projections through
``kernels.mixer_decode.ops.mixer_decode`` (``csrc/mixer_decode.cu``), whose
plain version is :func:`mixer_decode_step`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


# ---------------------------------------------------------------------------
# SSD core (also the kernel's plain version)
# ---------------------------------------------------------------------------

def segsum(a):
    """a: (..., Q) log-decay increments -> (..., Q, Q) lower-triangular
    segment sums: out[i, j] = sum_{t in (j, i]} a[t] for i >= j, -inf above
    the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, a, B, C, chunk, h0=None):
    """Chunked SSD scan.

    x: (b, s, h, p) inputs (already multiplied by dt); a: (b, s, h) log
    decay A*dt (<= 0); B, C: (b, s, n) input / output projections (one
    group, shared across heads) or (b, s, g, n) (g groups: head i reads
    group i // (h / g)); h0: optional (b, h, p, n) initial state.
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    g = B.shape[2] if B.dim() == 4 else 0
    Q = min(chunk, s)
    s_orig = s
    if s % Q:
        # zero inputs and zero log-decay: padded steps leave the state as it
        # is and add nothing, so the first s_orig positions are exact
        pad = Q - s % Q
        bc_pad = (0, 0) * (B.dim() - 2) + (0, pad)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, bc_pad)
        C = F.pad(C, bc_pad)
        s = s + pad
    nc = s // Q

    xr = x.reshape(b, nc, Q, h, p).float()
    Br = B.reshape(b, nc, Q, *B.shape[2:]).float()
    Cr = C.reshape(b, nc, Q, *C.shape[2:]).float()
    ar = a.reshape(b, nc, Q, h).permute(0, 3, 1, 2).float()   # (b,h,nc,Q)
    a_cs = torch.cumsum(ar, dim=-1)

    # intra-chunk (quadratic within a chunk)
    L = torch.exp(segsum(ar))                                  # (b,h,nc,Q,Q)
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)            # (b,h,nc,Q)
    if g:
        # heads as (group, head of the group): each group's B and C
        # serve its h / g heads
        xg = xr.reshape(b, nc, Q, g, h // g, p)
        scores = torch.einsum("bcqgn,bckgn->bcgqk", Cr, Br)
        y_diag = torch.einsum("bcgqk,bgjcqk,bckgjp->bcqgjp", scores,
                              L.reshape(b, g, h // g, nc, Q, Q),
                              xg).reshape(b, nc, Q, h, p)
        states = torch.einsum("bckgn,bgjck,bckgjp->bcgjpn", Br,
                              decay_states.reshape(b, g, h // g, nc, Q),
                              xg).reshape(b, nc, h, p, n)
    else:
        scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
        y_diag = torch.einsum("bcqk,bhcqk,bckhp->bcqhp", scores, L, xr)
        # chunk final states
        states = torch.einsum("bckn,bhck,bckhp->bchpn", Br, decay_states,
                              xr)

    # inter-chunk recurrence
    if h0 is None:
        h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.cat([h0[:, None].float(), states], dim=1)
    a_sum = F.pad(a_cs[..., -1], (1, 0))                       # (b,h,nc+1)
    decay_chunk = torch.exp(segsum(a_sum))                     # (b,h,nc+1,nc+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states = new_states[:, :-1]                           # entering chunk
    final_state = new_states[:, -1]

    state_decay = torch.exp(a_cs)                              # (b,h,nc,Q)
    if g:
        y_off = torch.einsum(
            "bcqgn,bcgjpn,bgjcq->bcqgjp", Cr,
            prev_states.reshape(b, nc, g, h // g, p, n),
            state_decay.reshape(b, g, h // g, nc, Q)).reshape(b, nc, Q, h, p)
    else:
        y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", Cr, prev_states,
                             state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), final_state


def ssd_decode_step(x, a, B, C, h_prev):
    """Single-token SSD state update.

    x: (b, h, p) (already * dt); a: (b, h); B, C: (b, n), or (b, g, n) for
    g groups (head i reads group i // (h / g)); h_prev: (b, h, p, n).
    Returns (y (b, h, p), h_new)."""
    decay = torch.exp(a.float())[..., None, None]
    if B.dim() == 3:
        rep = x.shape[1] // B.shape[1]
        Bh = B.float().repeat_interleave(rep, dim=1)           # (b, h, n)
        Ch = C.float().repeat_interleave(rep, dim=1)
        h_new = h_prev * decay + x.float()[..., None] * Bh[:, :, None, :]
        return torch.einsum("bhn,bhpn->bhp", Ch, h_new).to(x.dtype), h_new
    h_new = h_prev * decay + torch.einsum("bhp,bn->bhpn", x.float(),
                                          B.float())
    y = torch.einsum("bn,bhpn->bhp", C.float(), h_new)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 mixer layer
# ---------------------------------------------------------------------------

def init_mamba(generator, cfg, dtype, num_stacked):
    """Mixer weights stacked on a leading layer axis. ``A_log``, ``D`` and
    ``dt_bias`` are float32 whatever ``dtype`` is, as in the reference."""
    d, di = cfg.d_model, cfg.d_inner
    n = cfg.ssm.n_groups * cfg.ssm.d_state        # B (or C) columns
    h, ck, L = cfg.ssm_heads, cfg.ssm.conv_kernel, num_stacked
    dev = generator.device
    # dt bias: softplus(dt_bias) log-uniform in [1e-3, 1e-1]
    u = torch.rand((L, h), generator=generator, device=dev)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))                # inverse softplus
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return {
        "in_proj": dense_init(generator, (L, d, 2 * di + 2 * n + h),
                              dtype=dtype),
        "conv_w": dense_init(generator, (L, ck, di + 2 * n),
                             scale=1.0 / math.sqrt(ck), dtype=dtype),
        "conv_b": torch.zeros((L, di + 2 * n), dtype=dtype, device=dev),
        "A_log": a_log.expand(L, h).contiguous(),
        "D": torch.ones((L, h), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias.float(),
        "norm": torch.ones((L, di), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (L, di, d),
                               scale=1.0 / math.sqrt(di * 2 * cfg.num_layers),
                               dtype=dtype),
    }


def _split_proj(zxbcdt, cfg):
    di, n = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv. xBC: (B, S, Ch); w: (K, Ch)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def mamba_layer(x, p, cfg, *, state=None, use_kernel=False):
    """x: (B, S, D). With ``state`` (decode, S == 1): state = {"conv":
    (B, K-1, Ch), "ssm": (B, H, P, N) float32} -> returns the new state.
    Without (prefill): returns the final state for the decode handoff;
    ``use_kernel`` runs the scan through the SSD kernel's wrapper."""
    y, new_state = _mixer(x @ p["in_proj"], p, cfg, state=state,
                          use_kernel=use_kernel)
    return y @ p["out_proj"], new_state


def _gated_norm(gated, p, cfg):
    """The mixer's RMS norm of y * silu(z), over each group's columns."""
    G = cfg.ssm.n_groups
    if G > 1:
        return rms_norm(gated.unflatten(-1, (G, -1)),
                        p["norm"].unflatten(-1, (G, -1)),
                        cfg.norm_eps).flatten(-2)
    return rms_norm(gated, p["norm"], cfg.norm_eps)


def mixer_decode_step(zxbcdt, state, p, cfg):
    """One token of the mixer between its projections, and the plain
    version of the mixer decode kernel (``kernels/mixer_decode``):
    ``zxbcdt`` (B, 1, 2 di + 2 n + h), ``state`` {"conv": (B, K-1, Ch),
    "ssm": (B, H, P, N) float32} -> (the gated, normed y (B, 1, di), the
    new state, in new tensors)."""
    B = zxbcdt.shape[0]
    G = cfg.ssm.n_groups
    di, n, h = cfg.d_inner, G * cfg.ssm.d_state, cfg.ssm_heads
    P = cfg.ssm.head_dim
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    A = -torch.exp(p["A_log"])                                 # (h,) negative
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, 1, h)
    window = torch.cat([state["conv"], xBC], dim=1)            # (B, K, Ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) \
        + p["conv_b"]
    xBC1 = F.silu(conv_out)[:, None, :]                        # (B, 1, Ch)
    xh = xBC1[..., :di].reshape(B, h, P)
    Bp = xBC1[:, 0, di:di + n]
    Cp = xBC1[:, 0, di + n:]
    if G > 1:
        Bp, Cp = (t.unflatten(-1, (G, -1)) for t in (Bp, Cp))
    dt1 = dt[:, 0]                                             # (B, h)
    y, ssm_new = ssd_decode_step(xh * dt1[..., None].to(xh.dtype),
                                 dt1 * A[None, :], Bp, Cp, state["ssm"])
    y = (y + p["D"][None, :, None].float() * xh.float()).to(zxbcdt.dtype)
    y = y.reshape(B, 1, di)
    return _gated_norm(y * F.silu(z), p, cfg), {"conv": window[:, 1:, :],
                                                "ssm": ssm_new}


def _mixer(zxbcdt, p, cfg, *, state=None, use_kernel=False):
    """The mixer between its two projections: ``zxbcdt`` (B, S, 2 di + 2 n
    + h), the whole in_proj output -> (the gated, normed y (B, S, di), the
    new state), as :func:`mamba_layer` describes. A decode step with
    ``use_kernel`` runs through the mixer decode kernel's wrapper where
    the kernel takes the config and dtype (``kernels.mixer_decode.ops.
    takes``): on the card it updates the state's tensors in place and
    returns them."""
    B, S, _ = zxbcdt.shape
    G = cfg.ssm.n_groups
    di, n, h = cfg.d_inner, G * cfg.ssm.d_state, cfg.ssm_heads
    P = cfg.ssm.head_dim

    if state is None:
        z, xBC, dt = _split_proj(zxbcdt, cfg)
        A = -torch.exp(p["A_log"])                             # (h,) negative
        dt = F.softplus(dt.float() + p["dt_bias"])             # (B, S, h)
        if use_kernel:
            # the wrapper's module imports this one for its plain version
            from repro_torch.kernels.ssd.ops import ssd as scan
        else:
            scan = ssd_chunked
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xh = xBC[..., :di].reshape(B, S, h, P)
        Bp = xBC[..., di:di + n]
        Cp = xBC[..., di + n:]
        if G > 1:       # (B, S, G, d_state) views
            Bp, Cp = (t.unflatten(-1, (G, -1)) for t in (Bp, Cp))
        # x * dt is rounded to x's dtype before the scan; a = dt * A stays
        # float32, as in the reference
        y, final = scan(xh * dt[..., None].to(xh.dtype),
                        dt * A[None, None, :], Bp, Cp, cfg.ssm.chunk)
        y = y + p["D"][None, None, :, None].to(y.dtype) * xh
        # pre-activation conv inputs for the decode handoff, zero-left-padded
        # when the prompt is shorter than the conv's receptive field
        K1 = cfg.ssm.conv_kernel - 1
        tail = _split_proj(zxbcdt, cfg)[1][:, max(0, S - K1):, :]
        if S < K1:
            tail = F.pad(tail, (0, 0, K1 - S, 0))
        return (_gated_norm(y.reshape(B, S, di) * F.silu(z), p, cfg),
                {"conv": tail, "ssm": final})
    step = mixer_decode_step
    if use_kernel:
        # the wrapper's module imports this one for its plain version
        from repro_torch.kernels.mixer_decode.ops import mixer_decode, takes
        if takes(cfg, zxbcdt.dtype, zxbcdt.device):
            step = mixer_decode
    return step(zxbcdt, state, p, cfg)


def mamba_layer_sharded(x, ps, cfg, gather, reduce, *, states=None,
                        use_kernel=False):
    """:func:`mamba_layer` over the shards of a tensor-parallel mesh, with
    the reference's placement: ``in_proj`` split by columns, ``out_proj``
    by rows, the rest of the mixer's weights and its state replicated.

    x: (B, S, D) on the lead device; ``ps``: each shard's mixer weights on
    its device (an unsplit weight is whole on every shard; data-split
    slices are gathered by the caller); ``states``:
    each shard's own copy of the decode state (None: prefill);
    ``gather(parts)`` concatenates the shards' last dims on the lead
    device, ``reduce(partials)`` sums them there.

    The column blocks of ``x @ in_proj`` are gathered into the whole
    ``zxbcdt`` first: the contiguous split cuts across the z / xBC / dt
    boundaries, so no shard can use its block alone. Each shard then runs
    the causal conv, the scan (``ssd`` through its wrapper with
    ``use_kernel``, one call a shard), ``D`` and the gated norm over the
    full ``d_inner`` on its own copy of the state, and projects its row
    block of y; the partials are summed by ``reduce``. A projection whose
    dimension does not divide over the shards is whole on every shard and
    computed once, on the lead device. Returns (out (B, S, D) on the lead
    device, each shard's new state)."""
    whole = (2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
             + cfg.ssm_heads)
    if ps[0]["in_proj"].shape[-1] < whole:
        zxbcdt = gather([x.to(p["in_proj"].device) @ p["in_proj"]
                         for p in ps])
    else:
        zxbcdt = x @ ps[0]["in_proj"]
    ys, new_states = [], []
    for s, p in enumerate(ps):
        y, st = _mixer(zxbcdt.to(p["in_proj"].device), p, cfg,
                       state=None if states is None else states[s],
                       use_kernel=use_kernel)
        ys.append(y)
        new_states.append(st)
    rows = ps[0]["out_proj"].shape[0]
    if rows < cfg.d_inner:
        out = reduce([y[..., s * rows:(s + 1) * rows] @ p["out_proj"]
                      for s, (y, p) in enumerate(zip(ys, ps))])
    else:
        out = ys[0] @ ps[0]["out_proj"]
    return out, new_states
