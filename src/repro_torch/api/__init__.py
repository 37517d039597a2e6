"""API surface of the port (only the stream frame so far)."""
