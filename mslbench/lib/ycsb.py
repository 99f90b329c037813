"""YCSB's scrambled zipfian key chooser, drawn on the device from a seed.

A copy of the program's ``data/ycsb.py`` ``zipfian`` (YCSB's
ScrambledZipfianGenerator: a Zipf(alpha) popularity rank over ``n_keys``
items, hashed onto the key space so that hot keys spread over the sets),
rewritten so that the CDF, the uniform draws, the rank search and the
scrambling all run on the device in a few large calls.  Keys are int32 in
[1, n_keys].
"""

from __future__ import annotations

import torch

from mslbench.reference.murmur import fmix32

CHUNK = 1 << 26


def zipf_cdf(n_keys: int, alpha: float, device) -> torch.Tensor:
    """Normalised CDF of P(rank = i) ∝ 1 / (i + 1)^alpha, float64."""
    cdf = torch.arange(1, n_keys + 1, dtype=torch.float64, device=device)
    cdf.pow_(-alpha).cumsum_(0)
    return cdf.div_(cdf[-1].clone())


def rank_key(ranks: torch.Tensor, n_keys: int) -> torch.Tensor:
    """The scrambled key of a popularity rank."""
    return (fmix32(ranks) % n_keys + 1).to(torch.int32)


def zipfian(n_keys: int, n: int, alpha: float, gen: torch.Generator) -> torch.Tensor:
    """``n`` scrambled-zipfian keys on ``gen``'s device."""
    dev = gen.device
    cdf = zipf_cdf(n_keys, alpha, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, CHUNK):
        c = min(CHUNK, n - s)
        u = torch.rand(c, dtype=torch.float64, generator=gen, device=dev)
        out[s:s + c] = rank_key(torch.searchsorted(cdf, u), n_keys)
    return out
