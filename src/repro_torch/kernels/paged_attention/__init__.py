"""Paged decode attention: committed pages, optionally plus an in-flight
tail (``csrc/paged_attention.cu``)."""
