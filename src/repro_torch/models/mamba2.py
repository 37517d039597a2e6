"""Mamba2 mixer with the SSD (state-space duality) chunked scan (the port of
``repro/models/mamba2.py``) [arXiv:2405.21060].

``ssd_chunked`` here is the plain PyTorch scan and the SSD kernel's plain
version (``kernels/ssd/ref.py`` re-exports it); ``csrc/ssd.cu`` computes the
same math on the card. ``mamba_layer(..., use_kernel=True)`` sends its
prefill scan through the kernel's wrapper ``kernels.ssd.ops.ssd``.
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
    group, shared across heads); h0: optional (b, h, p, n) initial state.
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    s_orig = s
    if s % Q:
        # zero inputs and zero log-decay: padded steps leave the state as it
        # is and add nothing, so the first s_orig positions are exact
        pad = Q - s % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // Q

    xr = x.reshape(b, nc, Q, h, p).float()
    Br = B.reshape(b, nc, Q, n).float()
    Cr = C.reshape(b, nc, Q, n).float()
    ar = a.reshape(b, nc, Q, h).permute(0, 3, 1, 2).float()   # (b,h,nc,Q)
    a_cs = torch.cumsum(ar, dim=-1)

    # intra-chunk (quadratic within a chunk)
    L = torch.exp(segsum(ar))                                  # (b,h,nc,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    y_diag = torch.einsum("bcqk,bhcqk,bckhp->bcqhp", scores, L, xr)

    # chunk final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)            # (b,h,nc,Q)
    states = torch.einsum("bckn,bhck,bckhp->bchpn", Br, decay_states, xr)

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
    y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", Cr, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), final_state


def ssd_decode_step(x, a, B, C, h_prev):
    """Single-token SSD state update.

    x: (b, h, p) (already * dt); a: (b, h); B, C: (b, n); h_prev:
    (b, h, p, n). Returns (y (b, h, p), h_new)."""
    decay = torch.exp(a.float())[..., None, None]
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
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm.d_state
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
    di, n = cfg.d_inner, cfg.ssm.d_state
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
    B, S, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads
    P = cfg.ssm.head_dim
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    A = -torch.exp(p["A_log"])                                 # (h,) negative
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, S, h)

    if state is None:
        if use_kernel:
            # the wrapper's module imports this one for its plain version
            from repro_torch.kernels.ssd.ops import ssd as scan
        else:
            scan = ssd_chunked
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xh = xBC[..., :di].reshape(B, S, h, P)
        Bp = xBC[..., di:di + n]
        Cp = xBC[..., di + n:]
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
        new_state = {"conv": tail, "ssm": final}
    else:
        window = torch.cat([state["conv"], xBC], dim=1)        # (B, K, Ch)
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) \
            + p["conv_b"]
        xBC1 = F.silu(conv_out)[:, None, :]                    # (B, 1, Ch)
        xh = xBC1[..., :di].reshape(B, h, P)
        Bp = xBC1[:, 0, di:di + n]
        Cp = xBC1[:, 0, di + n:]
        dt1 = dt[:, 0]                                         # (B, h)
        y, ssm_new = ssd_decode_step(xh * dt1[..., None].to(xh.dtype),
                                     dt1 * A[None, :], Bp, Cp, state["ssm"])
        y = (y + p["D"][None, :, None].float() * xh.float()).to(x.dtype)
        y = y.reshape(B, 1, h, P)
        new_state = {"conv": window[:, 1:, :], "ssm": ssm_new}

    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state
