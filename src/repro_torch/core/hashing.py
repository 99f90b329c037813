"""Non-cryptographic hashing for set assignment, in PyTorch.

Port of ``repro.core.hashing``: the MurmurHash3 32-bit and 64-bit
finalizers (fmix32 / fmix64) that map a key onto a set.  PyTorch has no
full uint32 arithmetic, so every uint32 value is held in an int64 tensor
in [0, 2**32).  Shifts of such values are logical, and every product is
formed from 16-bit limbs so that no intermediate leaves the int64 range
(a plain ``x * 0x85EBCA6B`` of two 32-bit values can exceed 2**63).
"""

from __future__ import annotations

import torch

__all__ = ["fmix32", "fmix64_planes", "set_index", "fold_token_hash"]

MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 (or int64) bits as uint32, held in int64."""
    return x.to(torch.int64) & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 x (int64-held) and a uint32 constant c."""
    lo = (x & 0xFFFF) * c                        # < 2**48
    hi = ((x >> 16) * c) & 0xFFFF                # only 16 bits survive << 16
    return (lo + (hi << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer.  Returns uint32 values in int64."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def _mul64(ah, al, bh, bl):
    """64-bit multiply on (hi, lo) uint32 planes: (a * b) mod 2**64."""
    # Split into 16-bit limbs; every partial product is < 2**32.
    a0 = al & 0xFFFF
    a1 = al >> 16
    a2 = ah & 0xFFFF
    a3 = ah >> 16
    b0 = bl & 0xFFFF
    b1 = bl >> 16
    b2 = bh & 0xFFFF
    b3 = bh >> 16

    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    p02 = a0 * b2
    p20 = a2 * b0
    p12 = a1 * b2
    p21 = a2 * b1
    p03 = a0 * b3
    p30 = a3 * b0

    l0 = p00 & 0xFFFF
    c0 = p00 >> 16
    s1 = c0 + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    l1 = s1 & 0xFFFF
    c1 = (s1 >> 16) + (p01 >> 16) + (p10 >> 16)
    s2 = c1 + (p11 & 0xFFFF) + (p02 & 0xFFFF) + (p20 & 0xFFFF)
    l2 = s2 & 0xFFFF
    c2 = (s2 >> 16) + (p11 >> 16) + (p02 >> 16) + (p20 >> 16)
    s3 = c2 + p12 + p21 + p03 + p30  # only the low 16 bits survive mod 2**64
    l3 = s3 & 0xFFFF

    lo = l0 | (l1 << 16)
    hi = l2 | (l3 << 16)
    return hi, lo


def fmix64_planes(hi: torch.Tensor, lo: torch.Tensor):
    """MurmurHash3 64-bit finalizer on (hi, lo) uint32 planes (int64-held).

    x ^= x >> 33; x *= 0xff51afd7ed558ccd; x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53; x ^= x >> 33;
    """
    hi = as_u32(hi)
    lo = as_u32(lo)
    for mh, ml in ((0xFF51AFD7, 0xED558CCD), (0xC4CEB9FE, 0x1A85EC53)):
        lo = lo ^ (hi >> 1)                      # x ^= x >> 33 (hi ^= 0)
        hi, lo = _mul64(hi, lo, mh, ml)
    lo = lo ^ (hi >> 1)
    return hi, lo


def set_index(key: torch.Tensor, num_sets: int) -> torch.Tensor:
    """Map int32 key(s) to a set index in [0, num_sets) (a power of two)."""
    if num_sets <= 0 or num_sets & (num_sets - 1):
        raise ValueError(f"num_sets must be a power of two, got {num_sets}")
    return (fmix32(key) & (num_sets - 1)).to(torch.int32)


def fold_token_hash(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One step of a rolling hash over a token stream (for prefix caching).

    boost-style hash_combine on uint32:
    h ^= fmix32(tok) + 0x9e3779b9 + (h << 6) + (h >> 2)
    """
    h = as_u32(h)
    t = fmix32(tok)
    return h ^ ((t + 0x9E3779B9 + ((h << 6) & MASK32) + (h >> 2)) & MASK32)
