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
``jax.checkpoint(body)``. :class:`ServeStack` runs the serving engines'
layer loops, on one device or split over the shards of a tensor-parallel
mesh.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import DataSlices
from repro_torch.models.layers import (attention_layer,
                                       decode_attention_appended, dense_init,
                                       gated_gelu_mlp,
                                       head_dim_split_attention,
                                       init_attention, init_mlp, mlp_layer,
                                       project_qkv, rms_norm,
                                       split_heads_rope)
from repro_torch.models.mamba2 import mamba_layer_sharded
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_sharded
from repro_torch.serving.tracing import RECORDER
from repro_torch.tree import tree_leaves


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



class ServeStack:
    """The serving backends' layer ops of a decoder stack, on one device
    (``shard=None``) or over the N shards of a
    :class:`~repro_torch.distributed.sharding.ServeSharding` (Megatron-style
    tensor parallelism, one process driving every shard).

    The residual stream, norms and sampling inputs live on the lead device.
    Under a mesh the split weights work as follows (a weight the rules leave
    whole is used on the lead device alone):

    * embedding: vocab-parallel, each shard looks up the ids in its range
      (zeros elsewhere), summed by ``all_reduce``;
    * wq/wk/wv (+ biases), w1/w3: column-parallel; wo, w2: row-parallel,
      their partials summed by ``all_reduce``;
    * MoE expert stacks: split over the experts, the router replicated
      (:func:`~repro_torch.models.moe.moe_ffn_sharded`);
    * lm_head (or the tied embedding): column-parallel, the logits
      concatenated on the lead device;
    * the Mamba2 mixer (ssm and hybrid families, :meth:`mixer`): in_proj
      column-parallel and gathered, the conv, scan and gated norm on every
      shard's own copy of the state, out_proj row-parallel
      (:func:`~repro_torch.models.mamba2.mamba_layer_sharded`).

    A layer is addressed by its index in the stacked ``layers``, or by
    ``"shared"`` for the hybrid's one shared attention + MLP block
    (``params["shared"]``, not stacked), which every attention op below
    takes as well; the published Zamba2 layout's tied blocks
    (``params["blocks"]``, stacked over ``num_mem_blocks``) are
    ``("block", k)``, run by :meth:`tied_block` on one device only.

    :meth:`qkv` gives each shard its (q, k, v) at the cache's split
    (``kv_split``): with "heads" shard s holds kv heads [s KH/N, (s+1) KH/N)
    and their G KH/N query heads, projected from its own columns, so
    attention is shard-local; with "head_dim" the projections are gathered,
    rope'd, and each shard takes its head_dim slice (the attention then sums
    partial scores: ``layers.head_dim_split_attention``); with None every
    shard gets the whole q, k and v. On one device every op is the one the
    unsharded model runs.

    On a mesh whose ``data`` axis splits weights too (FSDP at serve, see
    ``ServeSharding``), a layer's data-split weights are gathered onto each
    model shard's device just before the layer's first use, for every
    shard at once, and dropped when the next layer (or ``"shared"``, or
    the embedding or head) is gathered: the peak is the slices plus one
    layer's gathered weights. The embedding and head gather theirs on each
    call. Every op then runs on exactly the tensors a ``(1, M)`` mesh
    holds, so no product contracts over a data-split dimension and the
    arithmetic is the ``(1, M)`` arithmetic, bit for bit.
    """

    def __init__(self, params, cfg, shard=None):
        self.cfg = cfg
        self.shard = shard
        if shard is None:
            self.params = [params]
            self.devices = [params["embed"].device]
            self.kv_split = "heads"
        else:
            self.params = shard.shard_params(params)
            self.devices = shard.devices
            self.kv_split = shard.kv_split
        self.n = len(self.params)
        self.layers = [[layer_params(p, i) for i in range(cfg.num_layers)]
                       for p in self.params]
        # the published hybrid's tied blocks and its per-application
        # weights (adapter, linear), as views
        self.tied, self.apps = {}, []
        if cfg.hybrid_layer_ids:
            if shard is not None:
                raise NotImplementedError(
                    "the published hybrid block serves on one device")
            self.tied = {("block", k): layer_params({"layers": params[
                "blocks"]}, k) for k in range(cfg.num_mem_blocks)}
            self.apps = [layer_params({"layers": params["apps"]}, j)
                         for j in range(len(cfg.hybrid_layer_ids))]
        self._fsdp = shard is not None and any(
            isinstance(x, DataSlices) for x in tree_leaves(self.params[0]))
        # the gathered weights of the layer in use: (key, one tree a shard)
        self._held = (None, None)
        whole = {"embed": cfg.vocab_size, "wq": cfg.q_dim,
                 "wk": cfg.kv_dim, "ffn": cfg.moe.num_experts if cfg.moe
                 else cfg.d_ff}
        self._split = {k: self.n > 1 and shard.rules._ax("model", v)
                       is not None for k, v in whole.items()}
        self._cfg_s = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.n,
            num_kv_heads=cfg.num_kv_heads // self.n) \
            if self.kv_split == "heads" else cfg

    def _lp(self, s: int, i):
        """Shard ``s``'s parameters of layer ``i`` (an index, or
        ``"shared"``), its data-split weights gathered."""
        if not self._fsdp:
            if isinstance(i, tuple):
                return self.tied[i]
            return self.params[s]["shared"] if i == "shared" \
                else self.layers[s][i]
        if self._held[0] != i:
            self._held = (None, None)       # the previous layer's go first
            self._held = (i, [
                self.shard.gather_tree(
                    p["shared"] if i == "shared" else lay[i], t)
                for t, (p, lay) in enumerate(zip(self.params,
                                                 self.layers))])
        return self._held[1][s]

    def _top(self, name: str):
        """A top-level weight (``embed`` or ``lm_head``) of every shard,
        gathered; whatever layer was held is dropped first."""
        self._held = (None, None)
        return [self.shard.gather(p[name], s) if self._fsdp else p[name]
                for s, p in enumerate(self.params)]

    def reduce(self, partials):
        """Sum of per-shard partials, on the lead device."""
        return partials[0] if self.n == 1 \
            else self.shard.all_reduce(partials)[0]

    def gather(self, parts):
        """The shards' parts concatenated along the last dim, on the lead
        device."""
        return parts[0] if self.n == 1 \
            else self.shard.all_gather(parts, dim=-1)

    def replicate(self, x):
        """``x`` on every shard's device."""
        return [x] if self.n == 1 else self.shard.replicate(x)

    # -- embedding and head ------------------------------------------------------
    def embed(self, tokens):
        """(B, S) token ids on the lead device -> (B, S, D)."""
        es = self._top("embed")
        if not self._split["embed"]:
            return es[0][tokens.long()]
        parts = []
        for e, dev in zip(es, self.devices):
            lo = len(parts) * e.shape[0]
            t = tokens.to(dev).long() - lo
            ok = ((t >= 0) & (t < e.shape[0]))[..., None]
            parts.append(torch.where(ok, e[t.clamp(0, e.shape[0] - 1)], 0))
        return self.reduce(parts)

    def head(self, h):
        """Hidden states (..., D) on the lead device -> the final norm, then
        float32 logits (..., V) on it."""
        h = rms_norm(h, self.params[0]["final_norm"], self.cfg.norm_eps)
        ws = self._top("lm_head") if "lm_head" in self.params[0] \
            else [e.T for e in self._top("embed")]
        if not self._split["embed"]:
            return (h @ ws[0]).float()
        return self.shard.all_gather(
            [(h.to(dev) @ w).float() for w, dev in zip(ws, self.devices)],
            dim=-1)

    # -- attention projections -----------------------------------------------------
    def _col(self, x, i, w, b):
        """x @ layer i's attention weight ``w`` (+ bias ``b``), whole, on
        the lead device."""
        ps = [self._lp(s, i)["attn"] for s in range(self.n)]
        split = self._split["wq" if w == "wq" else "wk"]
        outs = []
        for p, dev in list(zip(ps, self.devices))[:self.n if split else 1]:
            y = x.to(dev) @ p[w]
            outs.append(y + p[b] if self.cfg.qkv_bias else y)
        return self.shard.all_gather(outs, dim=-1) if split else outs[0]

    def qkv(self, x, i: int, positions):
        """Layer ``i``'s rope'd projections of the normed x (B, S, D) on
        the lead device: per shard (q (B,S,H_s,d_s), k and v (B,S,KH_s,d_s))
        on its device, at the cache's split."""
        if self.kv_split == "heads":
            return [project_qkv(x.to(dev), self._lp(s, i)["attn"],
                                self._cfg_s, positions.to(dev))
                    for s, dev in enumerate(self.devices)]
        q, k, v = split_heads_rope(self._col(x, i, "wq", "bq"),
                                   self._col(x, i, "wk", "bk"),
                                   self._col(x, i, "wv", "bv"), self.cfg,
                                   positions)
        if self.kv_split is None:
            return [(q.to(dev), k.to(dev), v.to(dev)) for dev in self.devices]
        d = self.cfg.head_dim // self.n
        return [tuple(t[..., s * d:(s + 1) * d].contiguous().to(dev)
                      for t in (q, k, v))
                for s, dev in enumerate(self.devices)]

    def out_proj(self, outs, i: int):
        """Layer ``i``'s output projection of the shards' attention outputs
        (B, S, H_s, d_s) -> (B, S, D) on the lead device."""
        ps = [self._lp(s, i)["attn"]["wo"] for s in range(self.n)]
        B, S = outs[0].shape[:2]
        if self.kv_split == "heads":
            return self.reduce([a.reshape(B, S, -1) @ w
                                for a, w in zip(outs, ps)])
        a = (self.shard.all_gather(outs, dim=-1) if self.kv_split
             else outs[0]).reshape(B, S, -1)
        if not self._split["wq"]:
            return a.to(self.devices[0]) @ ps[0]
        rows = a.shape[-1] // self.n
        return self.reduce([a[..., s * rows:(s + 1) * rows].to(w.device) @ w
                            for s, w in enumerate(ps)])

    def split_attention(self, qs, context, valid):
        """Attention over a cache whose kv heads are not split over the
        shards: with ``kv_split == "head_dim"`` every shard's partial
        scores are summed (:func:`head_dim_split_attention`), with None the
        lead shard attends alone over its whole copy. ``qs``: per-shard
        (B, T, H, d_s); ``context(s)``: shard s's (k, v) context
        (B, S, KH, d_s); ``valid``: (B, T, S) bool on the lead device.
        Returns per-shard (B, T, H, d_s) (the lead's alone with None)."""
        n = self.n if self.kv_split == "head_dim" else 1
        ctx = [context(s) for s in range(n)]
        return head_dim_split_attention(
            qs[:n], [k for k, _ in ctx], [v for _, v in ctx], valid,
            self.reduce if n > 1 else (lambda parts: parts[0]))

    # -- feed-forward ------------------------------------------------------------------
    def ffn(self, g, i: int):
        """Layer ``i``'s feed-forward of the normed g (B, S, D): the SwiGLU
        MLP, or MoE in "dense" mode (every expert on every token, as every
        serving path runs it)."""
        key = "moe" if self.cfg.moe else "mlp"
        if not self._split["ffn"]:
            lp = self._lp(0, i)[key]
            return moe_ffn(g, lp, self.cfg, mode="dense")[0] if self.cfg.moe \
                else mlp_layer(g, lp)
        ps = [self._lp(s, i)[key] for s in range(self.n)]
        if self.cfg.moe:
            return moe_ffn_sharded(g, ps, self.cfg, self.reduce)
        return self.reduce([mlp_layer(g.to(dev), p)
                            for p, dev in zip(ps, self.devices)])

    def block(self, h, i: int, positions, attend):
        """One layer on the residual stream h (B, S, D): ``attend(qkv)``
        takes :meth:`qkv`'s per-shard projections, writes the new KV into
        the cache and returns the per-shard attention outputs."""
        lp, eps = self._lp(0, i), self.cfg.norm_eps
        xa = rms_norm(h, lp["norm1"], eps)
        h = h + self.out_proj(attend(self.qkv(xa, i, positions)), i)
        return h + self.ffn(rms_norm(h, lp["norm2"], eps), i)

    def tied_block(self, h, e, j: int, positions, attend):
        """Application ``j`` of the published Zamba2 block, tied block
        j % ``num_mem_blocks``: attention over the norm of the stream h
        concatenated with the embeddings e (B, S, 2 D), the norm of its
        output through the gated-GELU MLP with application j's adapter,
        then application j's linear. No residual: the result T (B, S, D)
        is added to the input of the mamba layer at ``hybrid_layer_ids[j]``
        by the caller. ``attend`` as for :meth:`block`."""
        i = ("block", j % self.cfg.num_mem_blocks)
        bp, ap, eps = self._lp(0, i), self.apps[j], self.cfg.norm_eps
        u = rms_norm(torch.cat([h, e], dim=-1), bp["norm1"], eps)
        a = self.out_proj(attend(self.qkv(u, i, positions)), i)
        t = gated_gelu_mlp(rms_norm(a, bp["norm2"], eps), bp["mlp"],
                           (ap["adapter_in"], ap["adapter_out"]))
        return t @ ap["linear"]

    def decode_attend(self, kv, lens, lens_s, new, window=0,
                      use_kernel=False):
        """The ``attend`` of :meth:`block` for one decode step over a slot
        cache: ``kv`` the layer's per-shard (k, v) caches (B, KH_s, S,
        hd_s); ``lens`` (B,) lengths before this token on the lead device,
        ``lens_s`` the same on every shard's device; ``new`` per-shard
        (k list, v list) that collect the new token's (B, KH_s, hd_s)
        vectors, for the caller to write after the layer loop; ``window``
        the sliding window (0: none). ``use_kernel``: where each shard
        holds whole heads, the attention through the slot decode kernel's
        wrapper, once a shard; the head_dim split attends by the plain
        split path. Counts ``slot_decode_attn.kernel`` or ``.plain`` once
        an application."""
        def attend(qkv):
            for (_, k, v), (nk, nv) in zip(qkv, new):
                nk.append(k[:, 0])
                nv.append(v[:, 0])
            kernel = use_kernel and self.kv_split == "heads"
            RECORDER.count("slot_decode_attn.kernel" if kernel
                           else "slot_decode_attn.plain")
            if self.kv_split == "heads":
                attn = decode_attention_appended
                if kernel:
                    # the wrapper's module imports the layers module for
                    # its plain version
                    from repro_torch.kernels.slot_attention.ops import \
                        slot_decode_attention as attn
                return [attn(q, kc, vc, k[:, 0], v[:, 0], prev_len=n,
                             window=window, scale=self.cfg.attn_scale)
                        for (q, k, v), (kc, vc), n in zip(qkv, kv, lens_s)]

            def context(s):
                (kc, vc), (_, k, v) = kv[s], qkv[s]
                return (torch.cat([kc.transpose(1, 2), k], 1),
                        torch.cat([vc.transpose(1, 2), v], 1))
            S = kv[0][0].shape[2]
            pos = torch.arange(S + 1, device=lens.device)[None, :]
            prev = lens.long()[:, None]
            valid = pos < prev
            if window:
                valid = valid & (prev - pos < window)
            valid[:, S] = True                  # the new token itself
            return self.split_attention([q for q, _, _ in qkv], context,
                                        valid[:, None])
        return attend

    # -- the Mamba2 mixer -------------------------------------------------------
    def mixer(self, x, i: int, states=None, use_kernel=False):
        """Layer ``i``'s Mamba2 mixer of the normed x (B, S, D) on the lead
        device: ``states`` each shard's own decode state (None: prefill).
        ``use_kernel``: the prefill's scans through ``ssd`` and the decode
        step through the mixer decode kernel where it takes the config and
        dtype; a decode step counts ``mixer_decode.kernel`` or ``.plain``
        once an application. Returns (out (B, S, D) on the lead device,
        each shard's new state: in a decode step through the kernel, the
        given state's tensors, updated in place)."""
        if states is not None:
            # the wrapper's module imports the model modules for its plain
            # version
            from repro_torch.kernels.mixer_decode.ops import takes
            kernel = use_kernel and takes(self.cfg, x.dtype, x.device)
            RECORDER.count("mixer_decode.kernel" if kernel
                           else "mixer_decode.plain")
        return mamba_layer_sharded(
            x, [self._lp(s, i)["mamba"] for s in range(self.n)], self.cfg,
            self.gather, self.reduce, states=states, use_kernel=use_kernel)
