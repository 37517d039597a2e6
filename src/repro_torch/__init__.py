"""PyTorch/CUDA port of the FIRST serving stack.

A second package beside the JAX reference ``repro``: same module layout
(``repro_torch/models/layers.py`` <-> ``repro/models/layers.py``, ...),
PyTorch on the host side, hand-written CUDA C++ kernels for Hopper
(``csrc/``) where the reference has Pallas TPU kernels. It imports nothing
from ``repro`` and nothing from ``jax``; only the parity tests import both.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
