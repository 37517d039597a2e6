"""Mamba2 SSD chunked scan (``csrc/ssd.cu``)."""
