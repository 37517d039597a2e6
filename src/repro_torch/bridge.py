"""Parameter bridge: the JAX package's parameter tree (and AdamW state),
as numpy, to the port's tensors.

The caller converts the JAX tree to numpy itself (the parity tests call
``jax.tree.map(np.asarray, params)``), so the port never sees a JAX array.
Keys and layouts are kept as they are: ``embed`` (V, d), ``layers.*``
stacked on a leading L axis, ``final_norm``, optional ``lm_head`` (d, V),
and every projection in the reference's ``(in, out)`` layout, applied as
``x @ w`` by :mod:`repro_torch.models.layers` -- no transposes anywhere.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax_numpy(tree, cfg, device, dtype=None):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``. Leaves in the reference's param dtype (``cfg.param_dtype``)
    take ``dtype`` (default: that dtype); any other leaf keeps its own, so
    the float32 leaves the reference keeps whatever the param dtype (a
    mamba layer's ``A_log``, ``D`` and ``dt_bias``) stay float32. bfloat16
    leaves (numpy's ml_dtypes extension type) go through float32, which
    holds them exactly."""
    dtype = dtype or getattr(torch, cfg.param_dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        name = str(np.asarray(x).dtype)
        to = dtype if name == cfg.param_dtype else getattr(torch, name)
        arr = np.array(x, dtype=np.float32)       # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=to)

    out = conv(dict(tree))
    missing = {"embed", "layers", "final_norm"} - set(out)
    if missing:
        raise KeyError(f"parameter tree lacks {sorted(missing)}")
    if not cfg.tie_embeddings and "lm_head" not in out:
        raise KeyError("untied config but the tree has no 'lm_head'")
    return out


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax_numpy`, as float32 numpy."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def opt_state_from_jax_numpy(state, device):
    """The reference's AdamW state ({'m', 'v'} float32 trees and an int32
    'step'), as numpy, to the port's: the same trees of float32 tensors on
    ``device`` and a 0-d int32 step tensor."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    return {"m": conv(dict(state["m"])), "v": conv(dict(state["v"])),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
