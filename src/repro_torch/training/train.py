"""Training step (the port of ``repro/training/train.py``): remat'd forward
and backward with gradient accumulation over microbatches, then AdamW.

Gradients come from ``torch.autograd.grad`` over the flattened parameter
leaves (aliases of the caller's tensors made to require grad; the caller's
tree is not touched). With one microbatch they are in the parameter dtype;
with ``n`` they are summed into float32 zeros and divided by ``n``, and the
loss is the mean of the microbatch losses, as the reference's ``lax.scan``
over microbatches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.tree import tree_leaves, tree_unflatten


def batch_to(batch, device):
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


def loss_and_grads(model, params, batch, num_microbatches=1, remat=True):
    """(loss, grads): the mean loss over ``batch`` and its gradients, a
    tree like ``params``. ``batch`` leaves (tensors on the parameters'
    device) have the global batch leading; it is split into
    ``num_microbatches`` sequential accumulation steps."""
    leaves = tree_leaves(params)
    dev = leaves[0].device

    def one(mb):
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, _ = model.train_loss(tree_unflatten(params, xs), mb,
                                       remat=remat)
            gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True)
        return loss.detach(), gs

    n = num_microbatches
    if n == 1:
        loss, grads = one(batch)
    else:
        mbs = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
               for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            mb_loss, gs = one({k: v[i] for k, v in mbs.items()})
            for acc, g in zip(grads, gs):
                acc.add_(g)
            del gs
            loss = loss + mb_loss
        # true divisions by a device scalar, as the reference divides
        nf = torch.tensor(float(n), dtype=torch.float32, device=dev)
        grads = [g.div_(nf) for g in grads]
        loss = loss / nf
    return loss, tree_unflatten(params, grads)


def make_train_step(model, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    remat: bool = True, *, in_place: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {'loss', 'lr', 'grad_norm'}). ``batch`` (numpy arrays or
    tensors) goes to the parameters' device. ``in_place``: the step writes
    the new parameters and moments into the storage of the ones it was
    given (the counterpart of the reference's ``donate_argnums``); off, a
    step leaves its inputs as they were, so one state can be stepped
    twice."""

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        loss, grads = loss_and_grads(model, params, batch_to(batch, dev),
                                     num_microbatches, remat)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, in_place=in_place)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def init_training(model, generator: torch.Generator):
    """Random parameters on ``generator.device`` and a zero AdamW state."""
    params = model.init_params(generator)
    return params, adamw_init(params)
