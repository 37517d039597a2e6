"""SSM-only (Mamba2) and hybrid (Zamba2-style) stacks (the port of
``repro/models/hybrid.py``).

Hybrid = a Mamba2 backbone plus ONE shared attention+MLP block whose
parameters are reused at every application, after every ``attn_every``
mamba layers (the Zamba parameter-sharing trick); ``attn_every == 0`` gives
the pure SSM stack. The reference's scan over groups of scanned layers is a
pair of Python loops over per-layer views here. The training ``forward``
rematerialises each mamba sublayer and not the shared block, as the
reference's ``jax.checkpoint(inner)`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (attention_layer, dense_init,
                                       init_attention, init_mlp, mlp_layer,
                                       rms_norm)
from repro_torch.models.mamba2 import init_mamba, mamba_layer
from repro_torch.models.transformer import (_scatter_new_kv, layer_list,
                                            layer_params, remat_call)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_params(generator: torch.Generator, cfg):
    """Random parameters on ``generator.device`` (same tree, shapes and
    scales as the reference's ``init_params``; values from the torch
    generator)."""
    dtype, dev = _dtype(cfg), generator.device
    L, d = cfg.num_layers, cfg.d_model
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype),
        "layers": {"norm": torch.ones((L, d), dtype=dtype, device=dev),
                   "mamba": init_mamba(generator, cfg, dtype, L)},
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "lm_head": dense_init(generator, (d, cfg.vocab_size), dtype=dtype),
    }
    if cfg.attn_every:
        # one block, not stacked: the (1, ...) stacks' only entry
        attn = init_attention(generator, cfg, dtype, 1)
        mlp = init_mlp(generator, d, cfg.d_ff, cfg.num_layers, dtype, 1)
        params["shared"] = {
            "norm1": torch.ones((d,), dtype=dtype, device=dev),
            "attn": {k: w[0] for k, w in attn.items()},
            "norm2": torch.ones((d,), dtype=dtype, device=dev),
            "mlp": {k: w[0] for k, w in mlp.items()},
        }
    return params


def _group_params(cfg) -> tuple[int, int]:
    """(G groups, per mamba layers in a group). The reference reshapes the
    stacked layers (L, ...) to (G, per, ...) for its scan of scans; here
    layer ``g * per + j`` is the j-th of group g."""
    per = cfg.attn_every if cfg.attn_every else cfg.num_layers
    return cfg.num_layers // per, per


def _mamba_sublayer(x, lp, cfg, state=None, use_kernel=False):
    y, new_state = mamba_layer(rms_norm(x, lp["norm"], cfg.norm_eps),
                               lp["mamba"], cfg, state=state,
                               use_kernel=use_kernel)
    return x + y, new_state


def _shared_block(x, sp, cfg, positions, *, cache=None, cache_index=None,
                  window=0, return_kv=False, use_kernel=False):
    a, kv = attention_layer(rms_norm(x, sp["norm1"], cfg.norm_eps),
                            sp["attn"], cfg, positions=positions, cache=cache,
                            cache_index=cache_index, window=window,
                            return_kv=return_kv, use_kernel=use_kernel)
    x = x + a
    return x + mlp_layer(rms_norm(x, sp["norm2"], cfg.norm_eps),
                         sp["mlp"]), kv


def forward(params, x, cfg, *, remat=True, window=0):
    """Train forward. x: (B, S, D). Returns (hidden, aux=0). ``remat``:
    each mamba sublayer is recomputed in the backward (no effect without
    autograd); the shared block keeps its activations. Walks the same
    groups as :func:`prefill`."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    G, per = _group_params(cfg)
    sp = params.get("shared")
    layers = layer_list(params, cfg.num_layers)

    def inner(h, lp):
        return _mamba_sublayer(h, lp, cfg)[0]

    for g in range(G):
        for j in range(per):
            x = remat_call(inner, remat, x, layers[g * per + j])
        if sp is not None:
            x, _ = _shared_block(x, sp, cfg, positions, window=window)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(params, x, cfg, *, max_len=None, window=0, use_kernel=False):
    """x: (B, S, D) embeddings. Returns (hidden (B, S, D), cache): ssm
    (L, B, H, P, N) float32, conv (L, B, K-1, Ch), len (B,), and for the
    hybrid k/v (G, B, KH, max_len, hd) kv-heads-major. ``use_kernel``: the
    SSD scan and the shared attention through the kernels' wrappers."""
    B, S, _ = x.shape
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    G, per = _group_params(cfg)
    sp = params.get("shared")
    ssm, conv, ks, vs = [], [], [], []
    for g in range(G):
        for j in range(per):
            x, st = _mamba_sublayer(x, layer_params(params, g * per + j), cfg,
                                    use_kernel=use_kernel)
            ssm.append(st["ssm"])
            conv.append(st["conv"])
        if sp is not None:
            x, (k, v) = _shared_block(x, sp, cfg, positions, window=window,
                                      return_kv=True, use_kernel=use_kernel)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
    cache = {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    if sp is not None:
        pad = (0, 0, 0, max_len - S)
        cache["k"] = F.pad(torch.stack(ks), pad)
        cache["v"] = F.pad(torch.stack(vs), pad)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def decode_step(params, x, cfg, cache, *, window=0):
    """x: (B, 1, D). Returns (hidden (B, 1, D), cache). The cache is updated
    IN PLACE and returned (the reference returns a new one): each mamba
    layer's conv and ssm state right after the layer, the shared block's
    new kv vectors after the loop, as the reference scatters them."""
    lens = cache["len"]
    positions = lens[:, None].long()
    G, per = _group_params(cfg)
    sp = params.get("shared")
    new_k, new_v = [], []
    for g in range(G):
        for j in range(per):
            i = g * per + j
            x, st = _mamba_sublayer(
                x, layer_params(params, i), cfg,
                state={"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
        if sp is not None:
            x, (kn, vn) = _shared_block(
                x, sp, cfg, positions,
                cache={"k": cache["k"][g], "v": cache["v"][g]},
                cache_index=lens, window=window)
            new_k.append(kn)
            new_v.append(vn)
    if sp is not None:
        _scatter_new_kv(cache["k"], torch.stack(new_k), lens)
        _scatter_new_kv(cache["v"], torch.stack(new_v), lens)
    cache["len"] = lens + 1
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def init_cache(cfg, batch, max_len, dtype, device):
    L = cfg.num_layers
    H, P, N = cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    Ch = cfg.d_inner + 2 * N
    cache = {
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, cfg.ssm.conv_kernel - 1, Ch),
                            dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.attn_every:
        G = L // cfg.attn_every
        shape = (G, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
