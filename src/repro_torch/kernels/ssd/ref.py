"""Plain PyTorch versions of the SSD kernel.

``ssd_chunked`` (the chunked-einsum scan of ``repro_torch.models.mamba2``,
itself held against the step recurrence) is what a CPU tensor runs.
``ssd_passes_ref`` models the bf16 route of ``csrc/ssd.cu`` pass by pass,
with its rounding points; only the tests use it.
"""
import torch
import torch.nn.functional as F

from repro_torch.models.mamba2 import segsum, ssd_chunked, ssd_decode_step

__all__ = ["segsum", "ssd_chunked", "ssd_decode_step", "ssd_passes_ref"]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def ssd_passes_ref(x, a, B, C, chunk, *, emulate_kernel_rounding=True,
                   split_state=True):
    """The kernel's three passes in float32 PyTorch; same contract as
    ``ssd_chunked`` with ``h0 = 0``.

    1. chunk states: the inclusive cumsum ``acs`` of a per chunk and
       s_c = sum_j exp(acs_last - acs_j) x_j B_j^T;
    2. state pass: S_c = exp(a_sum_c) S_{c-1} + s_c in order, keeping the
       state entering each chunk and the final state;
    3. chunk scan: y_i = exp(acs_i) C_i S_{c-1}^T
       + sum_{j<=i} (C_i . B_j) exp(acs_i - acs_j) x_j.

    With ``emulate_kernel_rounding`` the values the kernel rounds to bf16
    for its tensor-core products are rounded here too: the decay-weighted x
    of pass 1 as a hi + lo pair of bf16 (one bf16 with ``split_state`` off,
    which costs the final state about 3e-3 of its scale), the entering
    states and the weights W of pass 3.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    pad = -s % Q
    # the ragged last chunk: zero input, zero decay
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    af = F.pad(a.float(), (0, 0, 0, pad))
    Bf = F.pad(B.float(), (0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, pad))
    nc = (s + pad) // Q
    xf = xf.reshape(b, nc, Q, h, p)
    Bf = Bf.reshape(b, nc, Q, n)
    Cf = Cf.reshape(b, nc, Q, n)
    acs = torch.cumsum(af.reshape(b, nc, Q, h), dim=2)      # (b, nc, Q, h)

    # pass 1
    a_sum = acs[:, :, -1]                                    # (b, nc, h)
    xw = xf * torch.exp(a_sum[:, :, None] - acs)[..., None]
    if emulate_kernel_rounding:
        hi = _bf16(xw)
        xw = hi + _bf16(xw - hi) if split_state else hi
    states = torch.einsum("bcqhp,bcqn->bchpn", xw, Bf)

    # pass 2
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = torch.exp(a_sum[:, c])[..., None, None] * S + states[:, c]
    prev = torch.stack(prev, 1)                              # (b, nc, h, p, n)
    if emulate_kernel_rounding:
        prev = _bf16(prev)

    # pass 3
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    i = torch.arange(Q, device=x.device)
    lower = (i[:, None] >= i[None, :])[..., None]            # (Q, Q, 1)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]      # (b, nc, i, j, h)
    W = G[..., None] * torch.exp(torch.where(lower, seg, -torch.inf))
    if emulate_kernel_rounding:
        W = _bf16(W)
    y = torch.einsum("bcijh,bcjhp->bcihp", W, xf) \
        + torch.exp(acs)[..., None] \
        * torch.einsum("bcin,bchpn->bcihp", Cf, prev)
    y = y.reshape(b, nc * Q, h, p)[:, :s]
    return y.to(x.dtype), S
