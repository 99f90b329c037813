"""PyTorch/CUDA port of the multi-step LRU cache (``repro`` is the JAX
reference it is held against).  See core/ for the cache and kernels/ for the
CUDA kernels and their plain versions."""
