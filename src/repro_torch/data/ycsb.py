"""YCSB client-emulator workload generators (zipfian / latest / scan).

The port's own copy of ``repro.data.ycsb`` (numpy only): the same seed gives
the same keys as the JAX package.  ``zipfian_tensor`` draws the same keys
as ``zipfian`` but does the rank search and the scrambling on a torch
device, which is what makes a stream over the paper's 100M keys cheap to
build.

Keys are int32 in [1, n_keys] (0 and the EMPTY sentinel are never emitted).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import fmix32

__all__ = ["zipfian", "zipfian_tensor", "latest", "scan", "make_workload"]


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """Vectorized MurmurHash3 finalizer (uint32), for rank scrambling."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _zipf_cdf(n_keys: int, alpha: float) -> np.ndarray:
    """Normalised CDF of P(rank=i) ∝ 1/(i+1)^alpha, built in one buffer."""
    cdf = np.arange(1, n_keys + 1, dtype=np.float64)
    np.power(cdf, alpha, out=cdf)
    np.divide(1.0, cdf, out=cdf)
    np.cumsum(cdf, out=cdf)
    cdf /= cdf[-1]
    return cdf


def _zipf_ranks(n_keys: int, n: int, alpha: float, rng) -> np.ndarray:
    """n samples of 0-based rank with P(rank=i) ∝ 1/(i+1)^alpha."""
    cdf = _zipf_cdf(n_keys, alpha)
    u = rng.random(n)
    return np.searchsorted(cdf, u, side="left").astype(np.int64)


def zipfian(n_keys: int, n_queries: int, alpha: float = 0.99,
            scrambled: bool = True, seed: int = 0) -> np.ndarray:
    """YCSB zipfian: static popularity ranking over n_keys items.

    ``scrambled`` hashes the rank onto the key space (YCSB's
    ScrambledZipfianGenerator) so hot keys are spread uniformly — this is
    what exercises set-conflict behaviour in a set-associative cache.
    """
    rng = np.random.default_rng(seed)
    ranks = _zipf_ranks(n_keys, n_queries, alpha, rng)
    if scrambled:
        keys = (_fmix32_np(ranks.astype(np.uint32)) % np.uint32(n_keys)).astype(np.int64)
    else:
        keys = ranks
    return (keys + 1).astype(np.int32)


def zipfian_tensor(n_keys: int, n_queries: int, alpha: float = 0.99,
                   scrambled: bool = True, seed: int = 0,
                   device="cuda") -> torch.Tensor:
    """``zipfian`` as an int32 tensor on ``device``, equal key for key.

    The CDF and the uniform draws come from numpy exactly as in ``zipfian``;
    the binary search and the scrambling run on ``device``.
    """
    rng = np.random.default_rng(seed)
    cdf = torch.from_numpy(_zipf_cdf(n_keys, alpha)).to(device)
    u = torch.from_numpy(rng.random(n_queries)).to(device)
    ranks = torch.searchsorted(cdf, u, side="left")
    del cdf
    keys = fmix32(ranks) % n_keys if scrambled else ranks
    return (keys + 1).to(torch.int32)


def latest(n_keys: int, n_queries: int, alpha: float = 0.99,
           insert_every: int = 8, seed: int = 0) -> np.ndarray:
    """YCSB latest: time-evolving popularity — newest insert is hottest.

    The key space grows by one every ``insert_every`` queries (starting from
    n_keys); query t targets ``newest_t - zipf_offset`` so the hot set drifts
    continuously.
    """
    rng = np.random.default_rng(seed)
    newest = n_keys + np.arange(n_queries, dtype=np.int64) // insert_every
    offs = _zipf_ranks(n_keys, n_queries, alpha, rng)
    keys = newest - np.minimum(offs, newest - 1)
    return (keys % np.int64(2**31 - 2) + 1).astype(np.int32)


def scan(n_keys: int, n_queries: int, alpha: float = 0.99,
         max_scan_len: int = 16, seed: int = 0) -> np.ndarray:
    """YCSB scan: a zipfian start key followed by a sequential range read.

    Emits runs [s, s+1, ..., s+L-1] with L ~ Uniform{1..max_scan_len};
    truncated to exactly n_queries requests.
    """
    rng = np.random.default_rng(seed)
    n_runs = max(1, 2 * n_queries // (max_scan_len + 1))
    starts = _zipf_ranks(n_keys, n_runs, alpha, rng)
    starts = (_fmix32_np(starts.astype(np.uint32)) % np.uint32(n_keys)).astype(np.int64)
    lens = rng.integers(1, max_scan_len + 1, size=n_runs)
    total = int(lens.sum())
    while total < n_queries:  # extremely unlikely; top up
        starts = np.concatenate([starts, starts[: n_runs // 2]])
        lens = np.concatenate([lens, lens[: n_runs // 2]])
        total = int(lens.sum())
    run_ids = np.repeat(np.arange(len(lens)), lens)
    base = np.repeat(starts, lens)
    cum = np.arange(len(run_ids)) - np.repeat(np.cumsum(lens) - lens, lens)
    keys = (base + cum) % n_keys
    return (keys[:n_queries] + 1).astype(np.int32)


def make_workload(name: str, n_keys: int, n_queries: int, alpha: float = 0.99,
                  seed: int = 0) -> np.ndarray:
    if name == "zipfian":
        return zipfian(n_keys, n_queries, alpha, seed=seed)
    if name == "latest":
        return latest(n_keys, n_queries, alpha, seed=seed)
    if name == "scan":
        return scan(n_keys, n_queries, alpha, seed=seed)
    raise ValueError(f"unknown workload {name!r}")
