"""Model facade (the port of ``repro/models/model.py``): init / prefill /
decode_step / init_cache / logits, dispatching on the config's family:

  dense | moe | vlm | audio -> transformer stack
  ssm | hybrid              -> mamba2 / zamba2 stack

The vlm and audio frontends are stubs, as in the reference: precomputed
features enter through ``batch["embeds"]``. Training (``train_loss``) is
not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import transformer as tf_mod

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
            hidden, _ = tf_mod.forward(params, x, cfg, window=window,
                                       use_kernel=use_kernel)
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
