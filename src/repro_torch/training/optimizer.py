"""AdamW (the port of ``repro/training/optimizer.py``). Moments are float32
whatever the parameter dtype; the update is computed in float32 and cast
back (bf16 params + float32 m/v is the deployment configuration).

The schedule and the bias corrections are float32 0-d tensors on the
parameters' device, computed with the reference's float32 operations in
its order: every division is a true division by a device tensor (PyTorch
multiplies by a host-computed reciprocal when the divisor is a Python
number on the card). Each leaf is updated in slices of its leading axis of
at most ``SLICE_ELEMS`` elements, so a float32 temporary takes a slice's
room, not the leaf's (at llama3.2-3b's width one MLP stack is 704.6 M
elements); the arithmetic is elementwise, so slicing changes no bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import tree_leaves, tree_map

SLICE_ELEMS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x, dev):
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to ``min_lr_ratio``; ``step`` is a
    0-d integer tensor, the result a 0-d float32 tensor on its device."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _slices(t):
    """Views of ``t`` along its leading axis, each of at most
    ``SLICE_ELEMS`` elements (the whole tensor when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return [...]
    rows = max(1, SLICE_ELEMS // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def global_norm(tree):
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum of
    float32 squares, as a 0-d float32 tensor."""
    total = 0
    for x in tree_leaves(tree):
        part = sum(torch.sum(torch.square(x[sl].to(torch.float32)))
                   for sl in _slices(x))
        total = total + part
    return torch.sqrt(total)


def adamw_update(params, grads, state, cfg: AdamWConfig, *, in_place=False):
    """One AdamW step. Returns (params, state, {'lr', 'grad_norm'}).
    ``in_place``: write the new parameters and moments into the storage of
    ``params`` and ``state`` (the counterpart of donating them to the
    reference's jitted step) instead of new tensors."""
    step = state["step"] + 1
    dev = step.device
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, dev) / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else _f32(1.0, dev)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        if in_place:
            po, mo, vo = p, m, v
        else:
            po, mo, vo = (torch.empty_like(p), torch.empty_like(m),
                          torch.empty_like(v))
        for sl in _slices(p):
            gs = g[sl].to(torch.float32) * scale
            ms = b1 * m[sl] + (1 - b1) * gs
            vs = b2 * v[sl] + (1 - b2) * torch.square(gs)
            mh = ms / bc1
            vh = vs / bc2
            pf = p[sl].to(torch.float32)
            pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                            + cfg.weight_decay * pf)
            po[sl] = pf.to(p.dtype)
            mo[sl] = ms
            vo[sl] = vs
        return po, mo, vo

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    # tree_map over ``out`` sees the tuples as leaves
    if in_place:
        state["step"].copy_(step)
        new_state = state
    else:
        new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}
