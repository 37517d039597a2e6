"""Model facade (the port of ``repro/models/model.py``): init / train_loss
/ prefill / decode_step / init_cache / logits, dispatching on the config's
family:

  dense | moe | vlm | audio -> transformer stack
  ssm | hybrid              -> mamba2 / zamba2 stack

The vlm and audio frontends are stubs, as in the reference: precomputed
features enter through ``batch["embeds"]``. ``train_loss`` is
differentiable with ``torch.autograd`` through plain PyTorch only: the
kernels' wrappers are forward only and refuse inputs that require grad.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import hints as _hints
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import transformer as tf_mod

MOE_AUX_COEF = 0.01
# context length beyond which hybrid archs switch their (shared) attention
# to a sliding window (the reference's long-context adaptation)
FULL_ATTN_MAX_CTX = 32_768


def _backend(cfg: ModelConfig):
    return hybrid_mod if cfg.family in ("ssm", "hybrid") else tf_mod


def _window_for(cfg: ModelConfig, ctx_len: int) -> int:
    if cfg.family == "hybrid" and ctx_len > FULL_ATTN_MAX_CTX:
        return cfg.sliding_window_long
    return 0


class LM:
    """Functional model wrapper: parameters are a nested dict of tensors
    passed to every call."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params ------------------------------------------------------------
    def init_params(self, generator: torch.Generator | None = None,
                    device=None):
        """Random parameters. ``generator`` fixes device and stream (its
        device wins); without one, a generator seeded 0 on ``device``
        (default: the CUDA device, RuntimeError without a card)."""
        if generator is None:
            generator = torch.Generator(device=resolve_device(device))
            generator.manual_seed(0)
        return _backend(self.cfg).init_params(generator, self.cfg)

    # -- inputs / outputs --------------------------------------------------
    def embed_inputs(self, params, batch):
        """batch has 'tokens' (B,S) integer or 'embeds' (B,S,D)."""
        if "embeds" in batch:
            return batch["embeds"].to(params["embed"].dtype)
        return params["embed"][batch["tokens"].long()]

    def logits(self, params, hidden):
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        return (hidden @ head).float()

    # -- training ----------------------------------------------------------
    def train_loss(self, params, batch, *, remat=True):
        """batch: {'tokens'|'embeds', 'labels' (B,S) integer}. Returns
        (loss, metrics {'ce', 'aux'}), all float32 scalars. The LM loss is
        the full-logit cross-entropy, or ``_chunked_ce`` when the current
        hints set ``ce_chunk`` below the vocabulary size."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        window = _window_for(cfg, x.shape[1])
        if cfg.family in ("ssm", "hybrid"):
            hidden, aux = hybrid_mod.forward(params, x, cfg, remat=remat,
                                             window=window)
        else:
            hidden, aux = tf_mod.forward(params, x, cfg, remat=remat,
                                         window=window)
        labels = batch["labels"].long()
        hp = _hints.current()
        chunk = hp.ce_chunk if hp is not None else None
        if chunk and cfg.vocab_size > chunk:
            ce = _chunked_ce(params, hidden, labels, chunk)
        else:
            logits = self.logits(params, hidden)           # (B,S,V) f32
            logz = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, labels[..., None])[..., 0]
            ce = (logz - ll).mean()
        loss = ce + MOE_AUX_COEF * aux
        return loss, {"ce": ce, "aux": aux}

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch, *, max_len=None, last_index=None,
                moe_mode="grouped", use_kernel=False):
        """Returns (logits of position ``last_index`` (default: the last)
        (B, V) float32, cache). The sliding window follows ``max_len`` (the
        cache's length), not the prompt's, as in the reference. An encoder
        returns the logits of every position (B, S, V) and no cache.
        ``moe_mode``: the MoE mode ("grouped", the reference's default, or
        "dense", which serving paths pass). ``use_kernel``: the prompt's
        attention and SSD scans through the hand-written kernels'
        wrappers."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        window = _window_for(cfg, max_len or x.shape[1])
        if cfg.is_encoder:
            hidden, _ = tf_mod.forward(params, x, cfg, remat=False,
                                       window=window, use_kernel=use_kernel)
            return self.logits(params, hidden), None
        kw = {"moe_mode": moe_mode} if cfg.family == "moe" else {}
        hidden, cache = _backend(cfg).prefill(
            params, x, cfg, max_len=max_len, window=window,
            use_kernel=use_kernel, **kw)
        idx = hidden.shape[1] - 1 if last_index is None else last_index
        return self.logits(params, hidden[:, idx]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B,) integer. Returns (logits (B, V), cache), the cache
        updated in place."""
        window = _window_for(self.cfg, _cache_ctx_len(self.cfg, cache))
        x = params["embed"][tokens.long()][:, None]
        hidden, cache = _backend(self.cfg).decode_step(params, x, self.cfg,
                                                       cache, window=window)
        return self.logits(params, hidden[:, 0]), cache

    def init_cache(self, batch, max_len, device=None):
        """Zeroed decode cache for ``batch`` sequences of up to ``max_len``
        tokens in the param dtype on ``device`` (default: the CUDA
        device)."""
        return _backend(self.cfg).init_cache(
            self.cfg, batch, max_len, getattr(torch, self.cfg.param_dtype),
            resolve_device(device))


def _cache_ctx_len(cfg, cache):
    # kv caches are (L|G, B, KH, S, hd): the sequence is dim 3
    if cfg.family in ("ssm", "hybrid"):
        return cache["k"].shape[3] if "k" in cache else 0
    return cache["k"].shape[3]


def make_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def _chunked_ce(params, hidden, labels, chunk):
    """Blockwise cross-entropy: a loop over vocab chunks of ``chunk``
    columns of the head (zero-padded to whole chunks, padded logits at
    -1e30) carrying the online logsumexp state, as the reference's scan.
    Under autograd each chunk is rematerialised, so the backward keeps
    only the (B, S) state between chunks, never the (B, S, V) logits."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    d, V = head.shape
    nc = -(-V // chunk)
    pad = nc * chunk - V
    if pad:
        head = torch.nn.functional.pad(head, (0, pad))
    B, S, _ = hidden.shape
    NEG = -1e30
    cols = torch.arange(chunk, device=hidden.device)

    def body(m, s, ll, w, i):
        lg = (hidden @ w).float()                          # (B,S,chunk)
        if pad:
            lg = torch.where((i * chunk + cols < V)[None, None, :], lg, NEG)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(lg - m_new[..., None]).sum(-1)
        loc = labels - i * chunk
        in_ch = (loc >= 0) & (loc < chunk)
        picked = lg.gather(-1, torch.clamp(loc, 0, chunk - 1)[..., None])
        ll = ll + torch.where(in_ch, picked[..., 0], 0.0)
        return m_new, s, ll

    state = (torch.full((B, S), NEG, dtype=torch.float32,
                        device=hidden.device),
             torch.zeros((B, S), dtype=torch.float32, device=hidden.device),
             torch.zeros((B, S), dtype=torch.float32, device=hidden.device))
    for i in range(nc):
        w = head[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            state = checkpoint(body, *state, w, i, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = body(*state, w, i)
    m, s, ll = state
    logz = m + torch.log(torch.clamp(s, min=1e-30))
    return (logz - ll).mean()
