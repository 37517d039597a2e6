"""Dense transformer stack (the port of ``repro/models/transformer.py``).

Parameters keep the reference's layout: every per-layer weight is stacked
on a leading L axis (``params["layers"]["attn"]["wq"]`` is (L, d, q_dim)),
so a bridged JAX tree maps key for key. The layer loop is a Python loop
over per-layer views (:func:`layer_params`) where the reference scans.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (attention_layer, dense_init,
                                       init_attention, init_mlp, mlp_layer,
                                       rms_norm)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_params(generator: torch.Generator, cfg):
    """Random parameters on ``generator.device`` (same shapes and scales as
    the reference's ``init_params``; values from the torch generator)."""
    dtype = _dtype(cfg)
    dev = generator.device
    L, d = cfg.num_layers, cfg.d_model
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype),
        "layers": {
            "norm1": torch.ones((L, d), dtype=dtype, device=dev),
            "attn": init_attention(generator, cfg, dtype, L),
            "norm2": torch.ones((L, d), dtype=dtype, device=dev),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.num_layers, dtype, L),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, cfg.vocab_size),
                                       dtype=dtype)
    return params


def layer_params(params, i: int):
    """Layer ``i``'s parameters: the same nested dict with every stacked
    leaf indexed at ``i`` (views, no copies)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


def _block(x, lp, cfg, positions, *, cache=None, cache_index=None,
           return_kv=False):
    """One transformer block. Returns (x, new_cache_or_kv)."""
    h, kv = attention_layer(
        rms_norm(x, lp["norm1"], cfg.norm_eps), lp["attn"], cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        return_kv=return_kv)
    x = x + h
    g = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + mlp_layer(g, lp["mlp"]), kv


def prefill(params, x, cfg, *, max_len=None):
    """Forward that also materializes the KV cache for decode.
    x: (B, S, D) embeddings. Returns (hidden (B,S,D), cache) with cache
    k/v (L, B, KH, max_len, hd) kv-heads-major and len (B,)."""
    B, S, _ = x.shape
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block(x, layer_params(params, i), cfg, positions,
                           return_kv=True)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    kc, vc = torch.stack(ks), torch.stack(vs)
    if max_len > S:
        pad = (0, 0, 0, max_len - S)
        kc, vc = torch.nn.functional.pad(kc, pad), \
            torch.nn.functional.pad(vc, pad)
    cache = {"k": kc, "v": vc,
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def decode_step(params, x, cfg, cache):
    """x: (B, 1, D) embedding of the new token. Returns (hidden (B,1,D),
    cache); the new kv vectors are written into a copy of the cache after
    the layer loop, at position ``cache["len"]``."""
    lens = cache["len"]
    positions = lens[:, None].long()
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        x, (kn, vn) = _block(x, layer_params(params, i), cfg, positions,
                             cache={"k": cache["k"][i], "v": cache["v"][i]},
                             cache_index=lens)
        new_k.append(kn)
        new_v.append(vn)
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)
    kc, vc = cache["k"].clone(), cache["v"].clone()
    # (B, S) leading view: row (b, lens[b]) of every layer and kv head
    kc.permute(1, 3, 0, 2, 4)[bidx, lens.long()] = \
        torch.stack(new_k, dim=1).to(kc.dtype)
    vc.permute(1, 3, 0, 2, 4)[bidx, lens.long()] = \
        torch.stack(new_v, dim=1).to(vc.dtype)
    new_cache = {"k": kc, "v": vc, "len": lens + 1}
    return rms_norm(x, params["final_norm"], cfg.norm_eps), new_cache

