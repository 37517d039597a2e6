"""Device policy of the port's entry points.

``LM.init_params``, ``PagedBackend`` and ``ContinuousBatchingEngine`` run
on the CUDA device by default. Without a card they raise instead of quietly
running on the CPU; the CPU is used only when a caller asks for it (the
parity tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (RuntimeError when there is no
    card); anything else -> ``torch.device(device)`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
