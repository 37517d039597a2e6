"""Synthetic workloads and token data (copies of the JAX package's
``repro/data``)."""
