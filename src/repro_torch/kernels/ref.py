"""Plain PyTorch version of the msl_access kernel (port of ``repro.kernels.ref``).

The reference is the algorithm layer itself (multistep.row_apply_ev /
row_access_ev); the CUDA kernel must reproduce it bit for bit on int32
planes.  Exposed with the kernel's flat signature so one entry point drives
both.
"""

from __future__ import annotations

import torch

from repro_torch.core.multistep import MSLRUConfig, row_access_ev, row_apply_ev

__all__ = ["msl_access_ref"]


def msl_access_ref(rows: torch.Tensor, qkeys: torch.Tensor, qvals: torch.Tensor,
                   cfg: MSLRUConfig, ops: torch.Tensor | None = None,
                   chain_live: torch.Tensor | None = None,
                   costs: torch.Tensor | None = None):
    """rows (B, A, C) int32, qkeys (B, KP), qvals (B, V), ops (B,) optional
    opcodes (None = all OP_ACCESS), chain_live (B,) optional execute mask
    for chain rows, costs (B,) optional insert costs (cost plane only).

    Returns (new_rows (B,A,C), hit (B,) int32, pos (B,) int32,
    value (B,V) int32, evicted (B,C) int32); evicted packs
    [key planes | value planes | cost plane] with key plane 0 == EMPTY_KEY
    when nothing was evicted.
    """
    if ops is None:
        new_rows, res, evicted = row_access_ev(cfg, rows, qkeys, qvals, costs)
    else:
        new_rows, res, evicted = row_apply_ev(cfg, rows, qkeys, qvals, ops,
                                              chain_live=chain_live, costs=costs)
    return (new_rows, res.hit.to(torch.int32), res.pos, res.value,
            evicted.contiguous())
