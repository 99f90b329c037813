"""Public wrappers around the msl_cache kernels (port of ``repro.kernels.ops``).

``onepass_update`` is the single-pass, conflict-aware batched update (the
main path): a prologue sorts the batch by set id once and derives the chain
metadata, the table is gathered once (a live row per distinct set; the
other chain members read the dummy row), every same-set chain is resolved
by ``msl_onepass_kernel_call``, and one scatter commits each chain's tail
row.  The optional ``ops``, ``chain_live`` and ``costs`` vectors ride the
same sort.  Contract: bit-exact with ``engine.batched_rounds_update`` — the
same (table, AccessResult, served) for any (valid, max_rounds, ops).

Unlike the TPU version, the prologue pads nothing and ranks chains over
the whole batch: CUDA blocks run in no order, so the kernel gives each
chain to one warp instead of carrying rows between blocks.  The path makes
no host sync, with or without a ``max_rounds`` cap.

The rounds engine (``engine.batched_rounds_update``) calls ``msl_access``
as its row transition; ``kernel_rounds_update`` and
``make_kernel_batched_engine`` keep the JAX package's names for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import (as_i32, batched_rounds_update,
                                     make_batched_engine, pad_dummy_row,
                                     sorted_group_ranks)
from repro_torch.core.invector import EMPTY_KEY
from repro_torch.core.multistep import AccessResult, MSLRUConfig
from repro_torch.kernels.msl_cache import (msl_access_kernel_call,
                                           msl_onepass_kernel_call)

__all__ = [
    "msl_access",
    "onepass_update",
    "onepass_update_",
    "onepass_prologue",
    "OnepassInputs",
    "kernel_rounds_update",
    "make_kernel_batched_engine",
]


def msl_access(rows, qkeys, qvals, *, cfg: MSLRUConfig, ops=None,
               chain_live=None, costs=None):
    """Mixed-op transition on pre-gathered rows (kernel on CUDA tensors)."""
    dev = rows.device
    return msl_access_kernel_call(rows, qkeys, qvals, as_i32(ops, dev),
                                  as_i32(chain_live, dev), as_i32(costs, dev),
                                  cfg=cfg)


# ---------------------------------------------------------------------------
# One-pass conflict-aware update
# ---------------------------------------------------------------------------

class OnepassInputs(NamedTuple):
    """The one-pass prologue's output: the batch sorted by set id."""

    order: torch.Tensor     # (B,) sort permutation (stable)
    sids: torch.Tensor      # (B,) int32 sorted set ids (S for invalid queries)
    firsts: torch.Tensor    # (B,) bool chain heads
    lasts: torch.Tensor     # (B,) bool chain tails
    rank: torch.Tensor      # (B,) int32 rank within the chain
    served: torch.Tensor    # (B,) int32: 0 = pass the row on untouched
    rows: torch.Tensor      # (B, A, C) gathered rows, live at chain heads
    qkeys: torch.Tensor     # (B, KP) and the optional operands, sorted
    qvals: torch.Tensor
    ops: torch.Tensor | None
    chain_live: torch.Tensor | None
    costs: torch.Tensor | None

    def kernel_args(self):
        """Positional arguments of ``msl_onepass_kernel_call``."""
        return (self.rows, self.qkeys, self.qvals, self.ops, self.sids,
                self.rank, self.served, self.chain_live, self.costs)


def onepass_prologue(padded, gsid, valid, qkeys, qvals, max_rounds=None,
                     ops=None, chain_live=None, costs=None) -> OnepassInputs:
    """Sort the batch by set id, rank each same-set chain and gather one live
    row per distinct set from ``padded`` ((S+1, A, C), last row the dummy;
    every other chain member reads the dummy)."""
    s = padded.shape[0] - 1
    b = gsid.shape[0]
    dev = padded.device
    sid_key = torch.where(valid, gsid.to(torch.int32), s)   # invalid -> dummy
    order = torch.sort(sid_key, stable=True).indices
    ssid = sid_key[order]
    firsts, rank = sorted_group_ranks(ssid)
    lasts = torch.ones((b,), dtype=torch.bool, device=dev)
    lasts[:-1] = ssid[:-1] != ssid[1:]
    served = valid[order]
    if max_rounds is not None:
        served = served & (rank < max_rounds)

    def sort(x):
        return None if x is None else as_i32(x, dev)[order].contiguous()

    return OnepassInputs(order, ssid, firsts, lasts, rank, served.to(torch.int32),
                         padded[torch.where(firsts, ssid, s)], sort(qkeys),
                         sort(qvals), sort(ops), sort(chain_live), sort(costs))


def onepass_update_(cfg: MSLRUConfig, padded, gsid, valid, qkeys, qvals,
                    max_rounds: int | None = None, ops=None, chain_live=None,
                    costs=None):
    """``onepass_update`` in place on ``padded``: the (S+1, A, C) table whose
    last row is the dummy that absorbs discarded writes.  Rows [0, S) are
    updated; returns (AccessResult, served).  Updating in place spares the
    caller a copy of the table for every batch."""
    s = padded.shape[0] - 1
    b = gsid.shape[0]
    kp, v = cfg.key_planes, cfg.value_planes
    x = onepass_prologue(padded, gsid, valid, qkeys, qvals, max_rounds, ops,
                         chain_live, costs)

    # --- resolve every chain; each chain's tail commits its set's row -----
    rows_after, hit, pos, val, ev = msl_onepass_kernel_call(*x.kernel_args(),
                                                            cfg=cfg)
    padded[torch.where(x.lasts, x.sids, s)] = rows_after  # non-tails: dummy

    # --- unsort; unserved queries report like the rounds engine -----------
    inv = torch.empty_like(x.order)
    inv[x.order] = torch.arange(b, device=padded.device)
    served = x.served[inv] != 0
    hit_u, pos_u, val_u, ev_u = hit[inv], pos[inv], val[inv], ev[inv]
    res = AccessResult(
        hit=(hit_u != 0) & served,
        value=torch.where(served[:, None], val_u, 0),
        pos=torch.where(served, pos_u, -1),
        evicted_key=torch.where(served[:, None], ev_u[:, :kp], 0),
        evicted_val=torch.where(served[:, None], ev_u[:, kp:kp + v], 0),
        evicted_valid=served & (ev_u[:, 0] != EMPTY_KEY),
    )
    return res, served


def onepass_update(cfg: MSLRUConfig, table, gsid, valid, qkeys, qvals,
                   max_rounds: int | None = None, ops=None, chain_live=None,
                   costs=None):
    """Single-pass exact multi-query update (one gather + one scatter).

    Same contract as ``engine.batched_rounds_update``: table (S, A, C);
    gsid (B,) set id per query (``valid`` False entries are ignored); ops,
    chain_live, costs (B,) optional; returns (table, AccessResult, served).
    ``max_rounds`` drops queries ranked past the cap in their set (hit
    False, served False); dropped queries pass their row on untouched.
    """
    padded = pad_dummy_row(table)
    res, served = onepass_update_(cfg, padded, gsid, valid, qkeys, qvals,
                                  max_rounds, ops, chain_live, costs)
    return padded[:-1], res, served


# ---------------------------------------------------------------------------
# The JAX package's kernel-engine names, over the same engines
# ---------------------------------------------------------------------------

def kernel_rounds_update(cfg: MSLRUConfig, table, gsid, valid, qkeys, qvals,
                         max_rounds: int | None = None, ops=None,
                         chain_live=None, costs=None):
    """``engine.batched_rounds_update``, whose row op is already
    ``msl_access``: it re-gathers and scatters all B rows once per conflict
    round.  Kept as the one-pass engine's oracle under its JAX name."""
    return batched_rounds_update(cfg, table, gsid, valid, qkeys, qvals,
                                 max_rounds, ops=ops, chain_live=chain_live,
                                 costs=costs)


def make_kernel_batched_engine(cfg: MSLRUConfig, engine: str = "onepass",
                               max_rounds: int | None = None):
    """``engine.make_batched_engine`` with the one-pass engine as default:
    on a table on the card both engines run their CUDA kernel.  Bit-exact
    w.r.t. ``make_sequential_engine`` for any ``max_rounds`` and opcode
    mix."""
    return make_batched_engine(cfg, max_rounds, engine=engine)
