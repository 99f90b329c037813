"""MurmurHash3's 32-bit finalizer, written out for the benchmark (numpy on
the host, torch on any device); the benchmark's key scrambling and the
cache reference's set assignment both use it.

Values are uint32 held in int64.  Each product is split at 16 bits of the
constant, so no intermediate leaves the int64 range.
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35


def _mul(x, c: int):
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def fmix32(x):
    """fmix32 of int arrays (numpy or torch), as uint32 in int64."""
    if isinstance(x, np.ndarray):
        x = x.astype(np.int64) & MASK32
    else:
        import torch
        x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul(x, C1)
    x = x ^ (x >> 13)
    x = _mul(x, C2)
    return x ^ (x >> 16)


def as_int32(x):
    """uint32 values held in int64 as the int32 with the same bits."""
    return ((x + 2**31) & MASK32) - 2**31
