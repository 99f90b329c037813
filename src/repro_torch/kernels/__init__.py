"""CUDA kernels of the cache's hot path (csrc/) with their wrappers and plain
PyTorch versions."""
