"""Model facade (the port of ``repro/models/model.py``): init / prefill /
decode_step / logits over the dense transformer stack.

Only the ``dense`` family is ported; the other families raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_mod

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 7 (MoE in 'dense' mode, phi3.5-moe)",
    "vlm": "ROADMAP Queue 1 item 7 (the vlm family of the LM facade)",
    "ssm": "ROADMAP Queue 1 item 9 (SSM/hybrid models)",
    "hybrid": "ROADMAP Queue 1 item 9 (SSM/hybrid models)",
    "audio": "ROADMAP Queue 1 item 13 (encoder serving surfaces)",
}


class LM:
    """Functional model wrapper: parameters are a nested dict of tensors
    passed to every call."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'see ROADMAP Queue 1')}")
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
        return tf_mod.init_params(generator, self.cfg)

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
    def prefill(self, params, batch, *, max_len=None, last_index=None):
        """Returns (logits of position ``last_index`` (default: the last)
        (B, V) float32, cache)."""
        x = self.embed_inputs(params, batch)
        hidden, cache = tf_mod.prefill(params, x, self.cfg, max_len=max_len)
        idx = hidden.shape[1] - 1 if last_index is None else last_index
        return self.logits(params, hidden[:, idx]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B,) integer. Returns (logits (B, V), new cache)."""
        x = params["embed"][tokens.long()][:, None]
        hidden, cache = tf_mod.decode_step(params, x, self.cfg, cache)
        return self.logits(params, hidden[:, 0]), cache


def make_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
