"""Paged flash prefill: causal attention of a prefill chunk over the page
pool (``csrc/paged_prefill.cu``)."""
