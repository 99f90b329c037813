"""Serving stack (port of ``repro.serving``): paged KV pool, prefix cache,
continuous-batching engine."""
