"""Plain float32 reference of the port's ``moe`` family (phi3.5-moe's
layers as the repo's family code writes them): per layer a pre-norm
grouped-query attention with interleaved RoPE, then a pre-norm mixture of
SwiGLU experts, each token sent to its top-k experts by a float32 softmax
router (ties to the lower index), the k gates renormalised to sum to 1.
RMSNorm throughout, no biases, an untied head.

Where that departs from the published Phi-3.5-MoE (LayerNorm with biases,
attention and head biases, the SparseMixer router with jitter, long-rope
scaling) the configuration file lists it; this reference follows the repo.

Layer-major over all the sequences it is given, so each layer's weights are
read once per call.
"""
from __future__ import annotations

import torch

from reference.common import (act, attention_block, exact, head_logits,
                              rms_norm, swiglu)


def logits(params, m: dict, seqs, precision: str = "float32"):
    """``seqs``: (token ids, first) pairs. Returns for each the float32
    logits (len - first, V) of positions first..len-1, the prediction of
    each next token."""
    E, k = m["moe"]["num_experts"], m["moe"]["top_k"]
    P = params["layers"]
    dev = params["embed"].device
    with exact():
        hs = [act(params["embed"][torch.as_tensor(t, device=dev)].float(),
                  precision) for t, _ in seqs]
        for i in range(m["num_layers"]):
            aw = {n: w[i] for n, w in P["attn"].items()}
            hs = [act(h + attention_block(h, P["norm1"][i], aw, m, precision),
                      precision) for h in hs]
            sizes = [h.shape[0] for h in hs]
            x = rms_norm(torch.cat(hs), P["norm2"][i], m["norm_eps"], precision)
            probs = torch.softmax(x @ P["moe"]["router"][i].float(), -1)
            vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
            idx = idx[:, :k]
            out = torch.zeros_like(x)
            for e in range(E):
                rows, slot = (idx == e).nonzero(as_tuple=True)
                if rows.numel() == 0:
                    continue
                y = swiglu(x[rows], P["moe"]["w1"][i, e], P["moe"]["w3"][i, e],
                           P["moe"]["w2"][i, e], precision)
                out.index_add_(0, rows, y * gates[rows, slot, None])
            hs = [act(h + o, precision) for h, o in zip(hs, out.split(sizes))]
        return [head_logits(h[first:], params["final_norm"], params["lm_head"],
                            m, precision) for h, (_, first) in zip(hs, seqs)]
