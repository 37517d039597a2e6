"""Hints and checkpoints of the port (``repro/distributed`` without the
mesh: ``sharding.py`` waits for ROADMAP Queue 1 item 11)."""
