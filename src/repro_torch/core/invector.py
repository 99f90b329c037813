"""In-vector LRU lane primitives, in PyTorch (port of ``repro.core.invector``).

Every state transition of in-vector LRU and multi-step LRU is one

    ``rotate_insert(row, lo, hi, item)``:
        new[lo]   = item
        new[j]    = row[j-1]    for lo < j <= hi
        new[j]    = row[j]      otherwise
        displaced = row[hi]

expressed here as selects over a lane-shifted copy, batched over any
leading dimensions.  The CUDA kernels in ``kernels/csrc/msl_cache.cu`` do
the same rotation with one ``__shfl_up_sync`` across a warp, the GPU form
of the paper's ``vpermd``.  All ops take ``rows`` of shape (..., A).
"""

from __future__ import annotations

import torch

__all__ = [
    "EMPTY_KEY",
    "rotate_insert",
    "find_key",
    "find_deepest_empty",
    "get_update_lo",
]

# Reserved sentinel for an empty slot (INT32_MIN); keys never take it.
EMPTY_KEY = -(2**31)


def _lane_iota(rows: torch.Tensor) -> torch.Tensor:
    """Lane index along the last axis, broadcastable against ``rows``."""
    return torch.arange(rows.shape[-1], dtype=torch.int32, device=rows.device)


def _max_lane(mask: torch.Tensor) -> torch.Tensor:
    """Largest lane index where ``mask`` holds along the last axis, else -1."""
    lane = _lane_iota(mask)
    return torch.where(mask, lane, -1).amax(dim=-1).to(torch.int32)


def find_key(rows: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Flat lane position of ``key`` in each row, or -1 if absent."""
    return _max_lane(rows == key[..., None])


def find_deepest_empty(rows: torch.Tensor) -> torch.Tensor:
    """Largest lane index holding EMPTY_KEY, or -1 if the row is full."""
    return _max_lane(rows == EMPTY_KEY)


def rotate_insert(rows, lo, hi, item):
    """Rotate lanes [lo, hi] right by one and write ``item`` at lo.

    rows (..., A); lo, hi (...,) int with 0 <= lo <= hi < A; item (...,).
    Returns (new_rows, displaced) where displaced = rows[hi].
    """
    lane = _lane_iota(rows)
    lo_b = lo[..., None]
    hi_b = hi[..., None]
    shifted = torch.roll(rows, 1, dims=-1)
    out = torch.where(lane == lo_b, item[..., None],
                      torch.where((lane > lo_b) & (lane <= hi_b), shifted, rows))
    displaced = torch.gather(rows, -1, hi_b.to(torch.int64))[..., 0]
    return out, displaced


def get_update_lo(pos: torch.Tensor, p: int) -> torch.Tensor:
    """Rotation start for a get hit at flat lane ``pos`` (paper §III.B).

    A hit inside a vector promotes to that vector's MRU slot (lo = vector
    start); a hit at a vector's MRU slot upgrades across vectors (lo =
    pos - 1); a hit at the global MRU is a no-op (lo = 0 = pos).
    """
    vec_start = (pos // p) * p
    lo = torch.where(pos % p > 0, vec_start, pos - 1)
    return torch.clamp_min(lo, 0)
