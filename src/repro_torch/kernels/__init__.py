"""Attention kernels of the port: hand-written CUDA C++ for Hopper
(``csrc/``), each beside its plain PyTorch version (``ref.py``)."""
