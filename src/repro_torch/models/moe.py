"""Top-k token-choice MoE (the port of ``repro/models/moe.py``).

Two execution modes, as in the reference:

* ``dense`` (every serving path): every expert computes every token and
  the results are combined by the gates in float32. No routing drops, so
  generation never depends on batch composition. The expert products are
  batched over E with the tokens broadcast -- ``x2d[None] @ w1`` gives
  (E, T, f) -- so no expert stack is permuted or copied: at serving width
  one (E, d, f) stack is hundreds of MB, read once a step.
* ``grouped`` (the default of ``LM.prefill`` and of ``forward``): per
  sequence each expert gathers its top-``capacity`` tokens by gate
  priority (dropping the rest), runs them, and the outputs come back to
  token order by a gather through the inverse permutation (``combine=
  "gather"``) or by a scatter-add (``"scatter"``). Differentiable: the
  training forward runs it under autograd.

Top-k selections break ties toward the lower index, as ``lax.top_k`` does
(a stable descending sort): ``torch.topk`` promises no order for ties.
Under a tensor-parallel mesh :func:`moe_ffn_sharded` splits "dense" mode
over the experts. The reference's expert-parallel hint (``moe_ep``, a
branch of its grouped mode for GSPMD) sits at the same place of the
grouped gather combine; it changes nothing on one device and tells the
dry run's step analysis of the reshard.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as _hints
from repro_torch.models.layers import dense_init, dense_init_stacked


def init_moe(generator, cfg, dtype, num_stacked):
    """MoE weights stacked on a leading layer axis of ``num_stacked``:
    router (L, d, E) float32 at scale 0.02, w1 / w3 (L, E, d, f) and w2
    (L, E, f, d) in ``dtype`` at 1/sqrt(f * 2 * num_layers). The expert
    stacks are drawn one layer at a time into tensors of ``dtype``."""
    d, f, L = cfg.d_model, cfg.d_ff, num_stacked
    E = cfg.moe.num_experts
    return {
        "router": dense_init(generator, (L, d, E), scale=0.02,
                             dtype=torch.float32),
        "w1": dense_init_stacked(generator, (L, E, d, f), dtype=dtype),
        "w3": dense_init_stacked(generator, (L, E, d, f), dtype=dtype),
        "w2": dense_init_stacked(generator, (L, E, f, d),
                                 scale=1.0 / math.sqrt(f * 2 * cfg.num_layers),
                                 dtype=dtype),
    }


def _top_k(x, k):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties toward the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(x, p, cfg):
    """Returns (gate_full (B,S,E), gates (B,S,k), idx (B,S,k), aux): float32
    router logits, softmax, top-k, gates renormalised over the k, and the
    Switch-style load-balance loss."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)    # (B,S,E)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, E).float()                          # (B,S,k,E)
    gate_full = (onehot * gates[..., None]).sum(dim=2)
    frac_tokens = (onehot.sum(dim=2) > 0).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * probs.mean(dim=(0, 1)))
    return gate_full, gates, idx, aux


def _dense_experts(x, p, gate_full):
    """Every expert of the stacks ``p`` (w1/w3 (E, d, f), w2 (E, f, d)) on
    every token of x (B, S, D), combined by ``gate_full`` (B, S, E) in
    float32. Returns (B * S, D) float32."""
    B, S, D = x.shape
    x2d = x.reshape(1, B * S, D)
    h1 = torch.matmul(x2d, p["w1"])                            # (E, T, f)
    h3 = torch.matmul(x2d, p["w3"])
    y = torch.matmul(F.silu(h1) * h3, p["w2"])                 # (E, T, D)
    return torch.einsum("etd,te->td", y.float(),
                        gate_full.reshape(B * S, -1))


def moe_ffn_sharded(x, ps, cfg, reduce):
    """``moe_ffn`` in "dense" mode with the experts split over shards
    (expert parallelism): ``ps[s]`` holds shard s's E/N experts (w1/w3/w2,
    whole: a ``ServeStack`` gathers any data-split slices first) and the
    replicated router. The router runs once, on the lead device's
    x, so every shard sees the same top-k and tie order; each shard
    computes its own experts on every token, gated, and ``reduce`` sums the
    shards' float32 outputs on the lead device. Returns (B, S, D) in x's
    dtype."""
    B, S, D = x.shape
    gate_full = _routing(x, ps[0], cfg)[0]
    n = gate_full.shape[-1] // len(ps)
    parts = []
    for s, p in enumerate(ps):
        dev = p["w1"].device
        parts.append(_dense_experts(x.to(dev), p,
                                    gate_full[..., s * n:(s + 1) * n].to(dev)))
    return reduce(parts).reshape(B, S, D).to(x.dtype)


def moe_ffn(x, p, cfg, mode="grouped", combine="gather"):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss). ``mode``:
    "dense" or "grouped" (which runs dense when S * k < 4 * E, as the
    reference); ``combine``: "gather" or "scatter" (grouped mode)."""
    B, S, D = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gate_full, gates, idx, aux = _routing(x, p, cfg)

    if mode == "dense" or S * k < 4 * E:
        out = _dense_experts(x, p, gate_full)
        return out.reshape(B, S, D).to(x.dtype), aux

    cap = int(math.ceil(cfg.moe.capacity_factor * S * k / E))
    cap = min(S, -(-cap // 4) * 4)                  # pad to a multiple of 4
    topc_gate, topc_idx = _top_k(gate_full.transpose(1, 2), cap)  # (B,E,cap)
    bb = torch.arange(B, device=x.device)[:, None, None]
    x_e = x[bb, topc_idx]                                       # (B,E,cap,D)
    # experts lead, so each product reads its expert's weights as they lie
    xs = x_e.permute(1, 0, 2, 3).reshape(E, B * cap, D)
    h = F.silu(torch.matmul(xs, p["w1"])) * torch.matmul(xs, p["w3"])
    y = torch.matmul(h, p["w2"]).reshape(E, B, cap, D).permute(1, 0, 2, 3)

    if combine == "gather":
        # pos[b, s, e] = slot of token s in expert e's buffer, or cap (a
        # zero row) where the token was dropped
        ee = torch.arange(E, device=x.device)[None, :, None]
        cc = torch.arange(cap, device=x.device).expand(B, E, cap)
        pos = torch.full((B, S, E), cap, dtype=torch.long, device=x.device)
        pos[bb, topc_idx, ee] = cc
        slot = pos.gather(2, idx)                               # (B,S,k)
        y = y.to(x.dtype)
        hp = _hints.current()
        if hp is not None and hp.moe_ep:
            # the experts replicated before the gather (the reference's
            # hint; one device is unchanged)
            y = _hints.constrain(y, (hp.dp or ("data",), None, None, None))
        y_pad = F.pad(y, (0, 0, 0, 1))                          # slot==cap -> 0
        yk = y_pad[bb, idx, slot]                               # (B,S,k,D)
        out = torch.einsum("bskd,bsk->bsd", yk.float(), gates)
        return out.to(x.dtype), aux

    y = y.float() * topc_gate[..., None]                # zero where gate == 0
    out = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, E * cap)
    out.index_put_((rows, topc_idx.reshape(B, E * cap)),
                   y.reshape(B, E * cap, D), accumulate=True)
    return out.to(x.dtype), aux
