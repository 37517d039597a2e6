"""Decode attention over the contiguous slot cache, plus the new token
(``csrc/slot_attention.cu``)."""
