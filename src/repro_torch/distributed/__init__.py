"""Hints, checkpoints and tensor-parallel sharding of the port
(``repro/distributed``)."""
