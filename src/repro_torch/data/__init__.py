"""Workload generators (numpy; no dependency on the JAX package)."""
