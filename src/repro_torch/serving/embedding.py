"""Embedding engine for encoder-only models (the port of
``repro/serving/embedding.py``; the Infinity-backend analogue: the paper
serves NV-Embed-v2 next to the LLMs).

The encoder runs over the whole padded (B, S) batch with NO key mask, as
in the reference: padded frames are attended, so an embedding moves when
only the padding does. The length mask enters only the mean pooling.
Attention goes through the ``flash_attention`` kernel's wrapper
(non-causal): CUDA tensors launch the kernel, CPU tensors run its plain
version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.models.transformer import forward as tf_forward


class EmbeddingEngine:
    def __init__(self, model: LM, params, max_batch: int = 16,
                 max_len: int = 512, device=None):
        """``device``: where the batch runs; default the CUDA device
        (RuntimeError without a card). ``params`` must live there."""
        if not model.cfg.is_encoder:
            raise ValueError(f"{model.cfg.name} is not an encoder")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len

    def embed(self, embeds_batch: np.ndarray, lengths: np.ndarray):
        """embeds_batch: (B, S, D) precomputed frontend features;
        lengths: (B,). Returns the L2-normalised mean-pooled embeddings
        (B, D) as float32 numpy (computed in the param dtype)."""
        params = self.params
        x = torch.as_tensor(np.asarray(embeds_batch), device=self.device)
        lens = torch.as_tensor(np.asarray(lengths), device=self.device)
        h, _ = tf_forward(params, x.to(params["embed"].dtype),
                          self.model.cfg, remat=False, use_kernel=True)
        return pool(h, lens).float().cpu().numpy()


def pool(h, lengths):
    """Mean of each row's first ``lengths`` positions of h (B, S, D), then
    L2-normalised, in h's dtype. Returns (B, D)."""
    mask = torch.arange(h.shape[1], device=h.device)[None, :] \
        < lengths[:, None]
    mask = mask[..., None].to(h.dtype)
    pooled = (h * mask).sum(1) / torch.clamp(mask.sum(1), min=1)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
