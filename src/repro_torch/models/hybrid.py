"""SSM-only (Mamba2) and hybrid (Zamba2-style) stacks (the port of
``repro/models/hybrid.py``).

Hybrid = a Mamba2 backbone plus ONE shared attention+MLP block whose
parameters are reused at every application, after every ``attn_every``
mamba layers (the Zamba parameter-sharing trick); ``attn_every == 0`` gives
the pure SSM stack. A config with ``hybrid_layer_ids`` has the published
Zamba2 layout instead: ``num_mem_blocks`` tied blocks (``params["blocks"]``)
applied in turn before the mamba layers at those ids, each application
with its own MLP adapter and output linear (``params["apps"]``), its
output added to that mamba layer's input (``ServeStack.tied_block``, the
one body of the block, which :func:`forward` also runs); it serves through
:func:`serve_prefill` and :func:`serve_decode_step` on one device (the
stacked-cache :func:`prefill` and :func:`decode_step` refuse it). The reference's scan over groups of
scanned layers is a pair of Python loops over per-layer views here. The
training ``forward`` rematerialises each mamba sublayer and not the shared
block, as the reference's ``jax.checkpoint(inner)`` does.

:func:`serve_prefill` and :func:`serve_decode_step` are :func:`prefill`
and :func:`decode_step` over a
:class:`~repro_torch.models.transformer.ServeStack`, on one device or the
shards of a tensor-parallel mesh: the mixers through ``ServeStack.mixer``,
the shared block through ``ServeStack.block`` (its attention at each
shard's heads, or the head_dim split), each shard with its own cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (attention_layer, chunked_attention,
                                       dense_init, init_attention, init_mlp,
                                       mlp_layer, rms_norm)
from repro_torch.models.mamba2 import init_mamba, mamba_layer
from repro_torch.models.transformer import (ServeStack, _scatter_new_kv,
                                            layer_list, layer_params,
                                            remat_call)
from repro_torch.serving.tracing import RECORDER


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
    if cfg.hybrid_layer_ids:
        params.update(_init_tied(generator, cfg, dtype))
        if cfg.tie_embeddings:
            del params["lm_head"]
    elif cfg.attn_every:
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


def _init_tied(generator, cfg, dtype):
    """The published layout's tied blocks (stacked over ``num_mem_blocks``)
    and per-application weights (stacked over the hybrid ids): fan-in
    scales, the outputs that reach the stream divided by sqrt(2 L)."""
    dev = generator.device
    d, f, r, L = cfg.d_model, cfg.d_ff, cfg.adapter_rank, cfg.num_layers
    nb, A = cfg.num_mem_blocks, len(cfg.hybrid_layer_ids)

    def w(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype)
    return {
        "blocks": {
            "norm1": torch.ones((nb, 2 * d), dtype=dtype, device=dev),
            "attn": {"wq": w((nb, 2 * d, cfg.q_dim)),
                     "wk": w((nb, 2 * d, cfg.kv_dim)),
                     "wv": w((nb, 2 * d, cfg.kv_dim)),
                     "wo": w((nb, cfg.q_dim, d))},
            "norm2": torch.ones((nb, d), dtype=dtype, device=dev),
            "mlp": {"gate_up": w((nb, d, 2 * f)),
                    "down": w((nb, f, d))}},
        "apps": {"adapter_in": w((A, d, r)), "adapter_out": w((A, r, 2 * f)),
                 "linear": w((A, d, d), 1.0 / math.sqrt(d * 2 * L))},
    }


def _no_tied(cfg, what):
    if cfg.hybrid_layer_ids:
        raise NotImplementedError(f"{what} of the published hybrid layout: "
                                  "it serves through serve_prefill and "
                                  "serve_decode_step")


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


def _forward_tied(params, x, cfg, positions, remat, window):
    """:func:`forward` at the published layout, x the embeddings: the tied
    block through ``ServeStack.tied_block`` (the body serving runs), its
    attention the plain causal one at the layout's scale."""
    stack = ServeStack(params, cfg, None)
    e, app = x, {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}

    def attend(qkv):
        return [chunked_attention(q, k, v, causal=cfg.causal, window=window,
                                  scale=cfg.attn_scale) for q, k, v in qkv]

    def inner(h, lp, t):
        y, _ = mamba_layer(rms_norm(h + t, lp["norm"], cfg.norm_eps),
                           lp["mamba"], cfg)
        return h + y

    for i, lp in enumerate(layer_list(params, cfg.num_layers)):
        t = stack.tied_block(x, e, app[i], positions, attend) \
            if i in app else 0.0
        x = remat_call(inner, remat, x, lp, t)
    return x


def forward(params, x, cfg, *, remat=True, window=0):
    """Train forward. x: (B, S, D). Returns (hidden, aux=0). ``remat``:
    each mamba sublayer is recomputed in the backward (no effect without
    autograd); the shared block keeps its activations. Walks the same
    groups as :func:`prefill`."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cfg.hybrid_layer_ids:
        x = _forward_tied(params, x, cfg, positions, remat, window)
        return (rms_norm(x, params["final_norm"], cfg.norm_eps),
                torch.zeros((), dtype=torch.float32, device=x.device))
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
    _no_tied(cfg, "prefill")
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
    _no_tied(cfg, "decode_step")
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


def serve_prefill(stack, tokens, *, max_len, window=0, use_kernel=False):
    """One-shot prefill of ``tokens`` (B, S) on the lead device through a
    ``ServeStack``. Returns (the last position's float32 logits (B, V) on
    the lead device, each shard's cache: ssm (L, B, H, P, N) float32, conv
    (L, B, K-1, Ch), and for the hybrid k/v (G, B, KH_s, max_len, hd_s) at
    the stack's kv split, G its applications of a shared block).
    ``use_kernel``: the scans through ``ssd`` and, where each shard holds
    whole heads, the shared attention through ``flash_attention`` at the
    shard's heads; a head_dim-split or replicated cache attends by the
    plain split path."""
    cfg = stack.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    n = stack.n
    ssm, conv, ks, vs = ([[] for _ in range(n)] for _ in range(4))
    if use_kernel:
        # the wrapper's module imports the model modules for its plain
        # version
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention as attn
    else:
        attn = chunked_attention

    def attend(qkv):
        for s, (_, k, v) in enumerate(qkv):
            ks[s].append(k.transpose(1, 2))
            vs[s].append(v.transpose(1, 2))
        if stack.kv_split == "heads":
            return [attn(q, k, v, causal=cfg.causal, window=window,
                         scale=cfg.attn_scale) for q, k, v in qkv]
        # (1, S, S): key j visible to query t iff j <= t (within window)
        gap = positions[:1, :, None] - positions[:1, None, :]
        visible = (gap >= 0) & ((gap < window) if window else True)
        return stack.split_attention([q for q, _, _ in qkv],
                                     lambda s: qkv[s][1:], visible)

    def mix(h, i, tied=None):
        lp = stack.layers[0][i]
        x = h if tied is None else h + tied
        y, states = stack.mixer(rms_norm(x, lp["norm"], cfg.norm_eps), i,
                                use_kernel=use_kernel)
        for s, st in enumerate(states):
            ssm[s].append(st["ssm"])
            conv[s].append(st["conv"])
        return h + y

    h = stack.embed(tokens)
    if cfg.hybrid_layer_ids:
        e, app = h, {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        for i in range(cfg.num_layers):
            h = mix(h, i, stack.tied_block(h, e, app[i], positions, attend)
                    if i in app else None)
    else:
        G, per = _group_params(cfg)
        for g in range(G):
            for j in range(per):
                h = mix(h, g * per + j)
            if cfg.attn_every:
                h = stack.block(h, "shared", positions, attend)
    if ks[0]:
        RECORDER.count("shared_block.apps", len(ks[0]))
    caches = []
    for s in range(n):
        c = {"ssm": torch.stack(ssm[s]), "conv": torch.stack(conv[s])}
        if ks[s]:
            pad = (0, 0, 0, max_len - S)
            c["k"] = F.pad(torch.stack(ks[s]), pad)
            c["v"] = F.pad(torch.stack(vs[s]), pad)
        caches.append(c)
    return stack.head(h[:, S - 1]), caches


def serve_decode_step(stack, tokens, caches, lens, *, window=0,
                      use_kernel=False):
    """One decode step of every row through a ``ServeStack``: tokens (B,)
    and ``lens`` (B,), the lengths before this token, on the lead device;
    ``caches`` each shard's {ssm, conv[, k, v]}, updated IN PLACE (each
    mixer's state after its layer, the shared block's new kv after the
    loop, as :func:`decode_step`). The caller advances the lengths.
    ``use_kernel``: the shared block's attention through the slot decode
    kernel where each shard holds whole heads (``ServeStack.
    decode_attend``), and the mixers' decode steps through the mixer
    decode kernel where it takes the config (``ServeStack.mixer``), which
    updates the state in place. Returns float32 logits (B, V) on the lead
    device."""
    cfg = stack.cfg
    lens_s = stack.replicate(lens)
    new = [([], []) for _ in range(stack.n)]

    def decode_mix(h, i, tied=None):
        lp = stack.layers[0][i]
        x = h if tied is None else h + tied
        old = [{"conv": c["conv"][i], "ssm": c["ssm"][i]} for c in caches]
        y, states = stack.mixer(rms_norm(x, lp["norm"], cfg.norm_eps), i,
                                states=old, use_kernel=use_kernel)
        for c, was, st in zip(caches, old, states):
            for key, new_state in st.items():
                if new_state is not was[key]:  # else updated in place
                    c[key][i] = new_state
        return h + y

    def cache_attend(g):
        return stack.decode_attend([(c["k"][g], c["v"][g]) for c in caches],
                                   lens, lens_s, new, window, use_kernel)

    h = stack.embed(tokens[:, None])
    positions = lens[:, None].long()
    if cfg.hybrid_layer_ids:
        e, app = h, {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        for i in range(cfg.num_layers):
            h = decode_mix(h, i, stack.tied_block(h, e, app[i], positions,
                                                  cache_attend(app[i]))
                    if i in app else None)
    else:
        G, per = _group_params(cfg)
        for g in range(G):
            for j in range(per):
                h = decode_mix(h, g * per + j)
            if cfg.attn_every:
                h = stack.block(h, "shared", positions, cache_attend(g))
    if new[0][0]:
        RECORDER.count("shared_block.apps", len(new[0][0]))
        for c, (nk, nv), n in zip(caches, new, lens_s):
            _scatter_new_kv(c["k"], torch.stack(nk), n)
            _scatter_new_kv(c["v"], torch.stack(nv), n)
    return stack.head(h[:, 0])


def init_cache(cfg, batch, max_len, dtype, device):
    L = cfg.num_layers
    H, P, N = cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    Ch = cfg.d_inner + 2 * cfg.ssm.n_groups * N
    cache = {
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, cfg.ssm.conv_kernel - 1, Ch),
                            dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.hybrid_layer_ids or cfg.attn_every:
        G = cfg.attn_layer_count()
        shape = (G, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
