"""Serving stack of the port: paged backend, engine, sampler, allocator."""
