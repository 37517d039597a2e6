"""Dense / MoE / VLM / audio-encoder transformer stack (the port of
``repro/models/transformer.py``).

Parameters keep the reference's layout: every per-layer weight is stacked
on a leading L axis (``params["layers"]["attn"]["wq"]`` is (L, d, q_dim)),
so a bridged JAX tree maps key for key. An MoE config has
``layers["moe"]`` (router and expert stacks) where the others have
``layers["mlp"]``. The layer loop is a Python loop over per-layer views
(:func:`layer_params`) where the reference scans. ``forward`` walks
per-layer views made by one ``unbind`` of each stacked leaf
(:func:`layer_list`), so a stacked leaf's gradient is put together once,
not summed from per-layer full-size zeros; with ``remat`` each block runs
under ``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint(body)``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (attention_layer, dense_init,
                                       init_attention, init_mlp, mlp_layer,
                                       rms_norm)
from repro_torch.models.moe import init_moe, moe_ffn


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
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if cfg.moe:
        params["layers"]["moe"] = init_moe(generator, cfg, dtype, L)
    else:
        params["layers"]["mlp"] = init_mlp(generator, d, cfg.d_ff,
                                           cfg.num_layers, dtype, L)
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


def layer_list(params, num_layers: int):
    """Every layer's parameters, from one ``unbind`` of each stacked leaf:
    the per-layer views of :func:`layer_params`, whose gradients autograd
    stacks once per leaf."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: p[i] for k, p in parts.items()}
                    for i in range(num_layers)]
        return tree.unbind(0)
    return split(params["layers"])


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, rematerialised in the backward when ``remat`` and
    autograd is recording (non-reentrant checkpoint; the model has no
    randomness, so no RNG state is kept)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _block(x, lp, cfg, positions, *, cache=None, cache_index=None,
           window=0, moe_mode="grouped", return_kv=False, use_kernel=False):
    """One transformer block. Returns (x, new_cache_or_kv, aux): ``aux``
    is the MoE load-balance loss (0 without MoE)."""
    h, kv = attention_layer(
        rms_norm(x, lp["norm1"], cfg.norm_eps), lp["attn"], cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        window=window, return_kv=return_kv, use_kernel=use_kernel)
    x = x + h
    g = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if cfg.moe:
        f, aux = moe_ffn(g, lp["moe"], cfg, mode=moe_mode)
    else:
        f = mlp_layer(g, lp["mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, kv, aux


def forward(params, x, cfg, *, remat=True, moe_mode="grouped", window=0,
            use_kernel=False):
    """Full-sequence forward (train / encoder). x: (B, S, D) embeddings.
    Returns (hidden (B,S,D), aux loss summed over layers). ``remat``:
    each block is recomputed in the backward instead of keeping its
    activations (no effect without autograd). ``use_kernel``: attention
    through the flash kernel's wrapper (causal or not, as the config says;
    forward only, so not under autograd)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    def body(h, lp):
        h2, _, a = _block(h, lp, cfg, positions, window=window,
                          moe_mode=moe_mode, use_kernel=use_kernel)
        return h2, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(params, cfg.num_layers):
        x, a = remat_call(body, remat, x, lp)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def prefill(params, x, cfg, *, max_len=None, window=0, moe_mode="grouped",
            use_kernel=False):
    """Forward that also materializes the KV cache for decode.
    x: (B, S, D) embeddings. Returns (hidden (B,S,D), cache) with cache
    k/v (L, B, KH, max_len, hd) kv-heads-major and len (B,).
    ``moe_mode``: serving paths pass "dense" (no capacity drops).
    ``use_kernel``: attention through the flash kernel's wrapper."""
    B, S, _ = x.shape
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v), _ = _block(x, layer_params(params, i), cfg, positions,
                              window=window, moe_mode=moe_mode,
                              return_kv=True, use_kernel=use_kernel)
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


def decode_step(params, x, cfg, cache, *, window=0):
    """x: (B, 1, D) embedding of the new token. Returns (hidden (B,1,D),
    cache). The cache is updated IN PLACE and returned (the reference
    returns a new one): the layer loop only collects each layer's new kv
    vectors, written after it at position ``cache["len"]``."""
    lens = cache["len"]
    positions = lens[:, None].long()
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        x, (kn, vn), _ = _block(x, layer_params(params, i), cfg, positions,
                                cache={"k": cache["k"][i],
                                       "v": cache["v"][i]},
                                cache_index=lens, window=window,
                                moe_mode="dense")
        new_k.append(kn)
        new_v.append(vn)
    _scatter_new_kv(cache["k"], torch.stack(new_k), lens)
    _scatter_new_kv(cache["v"], torch.stack(new_v), lens)
    cache["len"] = lens + 1
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def _scatter_new_kv(cache, new, lens):
    """Write new kv vectors into the stacked cache, in place.

    cache: (L, B, KH, S, hd); new: (L, B, KH, hd); lens: (B,) positions.
    A position past S is dropped, as the reference's out-of-bounds scatter
    drops it (a free slot's length keeps growing while the slot cache steps
    every slot): that row rewrites position S - 1 with its own value, so
    nothing waits on the host to filter rows."""
    B, S = cache.shape[1], cache.shape[3]
    bidx = torch.arange(B, device=cache.device)
    pos = torch.clamp(lens, max=S - 1).long()
    view = cache.permute(1, 3, 0, 2, 4)          # (B, S, L, KH, hd)
    dropped = (lens >= S)[:, None, None, None]
    view[bidx, pos] = torch.where(dropped, view[bidx, pos],
                                  new.permute(1, 0, 2, 3).to(cache.dtype))


def init_cache(cfg, batch, max_len, dtype, device):
    """Zeroed kv-heads-major cache: k/v (L, batch, KH, max_len, hd), len
    (batch,) int32."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}

