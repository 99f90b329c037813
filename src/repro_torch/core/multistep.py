"""Multi-step LRU set-associative cache (the paper's contribution), in PyTorch.

Port of ``repro.core.multistep``.  State is one int32 tensor ``table`` of
shape (S, A, C):

  * S = num_sets (power of two; a key is assigned to a set by fmix32),
  * A = M*P lanes per set, ordered hot->cold: lane a = m*P + p, where m is
    the vector (0 = hottest) and p the in-vector position (0 = MRU); the
    set's global LRU victim is always lane A-1,
  * C = key_planes + value_planes + cost_planes int32 planes.

Recency lives purely in lane order, and every mutation is one
``rotate_insert`` over a lane range applied to all C planes.  The row ops
below are the plain PyTorch form of that transition, batched over rows
(B, A, C); they are the reference the CUDA kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import hashing
from repro_torch.core.invector import EMPTY_KEY, get_update_lo

__all__ = [
    "MSLRUConfig",
    "AccessResult",
    "OP_ACCESS",
    "OP_GET",
    "OP_DELETE",
    "OP_LOOKUP",
    "OP_CHAIN_GET",
    "OP_CHAIN_PUT",
    "init_table",
    "row_lookup",
    "row_get",
    "row_put",
    "row_access",
    "row_access_ev",
    "row_delete",
    "row_apply",
    "row_apply_ev",
    "set_index_for",
]

POLICY_MULTISTEP = "multistep"
POLICY_SET_LRU = "set_lru"  # exact LRU *within* each set (baseline)

# Per-query opcodes.  The numbers are an on-device ABI shared with the JAX
# package and with the CUDA kernels (csrc/msl_cache.cu): keep them as is.
OP_ACCESS = 0      # get; on miss, put (the paper's benchmark op)
OP_GET = 1         # get only (a miss leaves the cache untouched)
OP_DELETE = 2      # invalidate in place
OP_LOOKUP = 3      # read-only probe (no recency update, no mutation)
OP_CHAIN_GET = 4   # GET while its chain is all-hits, else a no-op miss
OP_CHAIN_PUT = 5   # ACCESS past its chain's hit prefix, else a no-op miss

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class MSLRUConfig:
    """Static configuration of a multi-step LRU cache."""

    num_sets: int               # S, power of two
    m: int = 2                  # vectors per set (M); m=1 == in-vector LRU
    p: int = 4                  # lanes per vector (P)
    key_planes: int = 1         # 1 => 32-bit keys, 2 => 64-bit (hi, lo)
    value_planes: int = 2       # 2 => 64-bit values (pointers)
    cost_planes: int = 0        # 1 => cost-aware victim choice
    policy: str = POLICY_MULTISTEP

    def __post_init__(self):
        if self.num_sets <= 0 or self.num_sets & (self.num_sets - 1):
            raise ValueError("num_sets must be a power of two")
        if self.m < 1 or self.p < 1:
            raise ValueError("m and p must be >= 1")
        if self.key_planes not in (1, 2):
            raise ValueError("key_planes must be 1 or 2")
        if self.value_planes < 0:
            raise ValueError("value_planes must be >= 0")
        if self.cost_planes not in (0, 1):
            raise ValueError("cost_planes must be 0 or 1")
        if self.policy not in (POLICY_MULTISTEP, POLICY_SET_LRU):
            raise ValueError(f"unknown policy {self.policy!r}")

    @property
    def assoc(self) -> int:  # A
        return self.m * self.p

    @property
    def planes(self) -> int:  # C
        return self.key_planes + self.value_planes + self.cost_planes

    @property
    def capacity(self) -> int:
        return self.num_sets * self.assoc


class AccessResult(NamedTuple):
    """Outcome of a batch of cache operations."""

    hit: torch.Tensor            # (B,) bool
    value: torch.Tensor          # (B, V) value of the hit item (garbage if miss)
    pos: torch.Tensor            # (B,) flat lane of the hit, -1 on miss
    evicted_key: torch.Tensor    # (B, KP) key displaced by a put (EMPTY if none)
    evicted_val: torch.Tensor    # (B, V)
    evicted_valid: torch.Tensor  # (B,) bool: a real item was evicted


def init_table(cfg: MSLRUConfig, device="cuda") -> torch.Tensor:
    """Empty cache: key plane 0 = EMPTY_KEY sentinel, everything else 0."""
    t = torch.zeros((cfg.num_sets, cfg.assoc, cfg.planes), dtype=torch.int32,
                    device=device)
    t[:, :, 0] = EMPTY_KEY
    return t


def set_index_for(cfg: MSLRUConfig, qkeys: torch.Tensor) -> torch.Tensor:
    """Set assignment by the MurmurHash3 finalizer over key plane(s).

    qkeys (B, KP) int32; returns (B,) int32 set ids, bit-equal to the JAX
    package's ``set_index_for``.
    """
    if cfg.key_planes == 1:
        return hashing.set_index(qkeys[..., 0], cfg.num_sets)
    _, lo = hashing.fmix64_planes(qkeys[..., 0], qkeys[..., 1])
    return (lo & (cfg.num_sets - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# Lane helpers on plane-carrying rows (..., A, C)
# ---------------------------------------------------------------------------

def _lane(rows: torch.Tensor) -> torch.Tensor:
    """Lane iota along the A axis, broadcastable against rows[..., 0]."""
    return torch.arange(rows.shape[-2], dtype=torch.int32, device=rows.device)


def _max_lane(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, _lane(mask[..., None]), -1).amax(dim=-1).to(torch.int32)


def _find_key_planes(cfg, rows, qkeys):
    """Flat lane of the key match (-1 if absent); keys are unique in a row."""
    hit = (rows[..., :cfg.key_planes] == qkeys[..., None, :]).all(dim=-1)
    return _max_lane(hit)


def _find_deepest_empty_planes(rows):
    return _max_lane(rows[..., 0] == EMPTY_KEY)


def _take_lane(rows, lane):
    """rows[..., lane, :] per row: (..., A, C), (...,) -> (..., C)."""
    idx = lane.to(torch.int64)[..., None, None].expand(
        *rows.shape[:-2], 1, rows.shape[-1])
    return torch.gather(rows, -2, idx)[..., 0, :]


def _rotate_insert_planes(rows, lo, hi, item):
    """rotate_insert applied to all C planes of (..., A, C) rows.

    lo, hi (...,); item (..., C).  Returns (new_rows, displaced (..., C)).
    """
    lane = _lane(rows)[:, None]                          # (A, 1)
    lo_b = lo[..., None, None]
    hi_b = hi[..., None, None]
    shifted = torch.roll(rows, 1, dims=-2)
    out = torch.where(lane == lo_b, item[..., None, :],
                      torch.where((lane > lo_b) & (lane <= hi_b), shifted, rows))
    return out, _take_lane(rows, hi)


# ---------------------------------------------------------------------------
# Row-level operations (batched over a leading dim; rows (B, A, C))
# ---------------------------------------------------------------------------

def _values(cfg, item):
    return item[..., cfg.key_planes:cfg.key_planes + cfg.value_planes]


def row_lookup(cfg: MSLRUConfig, rows, qkeys):
    """Read-only probe: (hit (B,), value (B, V), pos (B,))."""
    pos = _find_key_planes(cfg, rows, qkeys)
    item = _take_lane(rows, pos.clamp_min(0))
    return pos >= 0, _values(cfg, item), pos


def row_get(cfg: MSLRUConfig, rows, qkeys):
    """get: probe + recency update (promote within vector / upgrade across).

    Returns (new_rows, hit, value, pos).  A miss is a provable no-op: the
    rotation degenerates to re-writing lane 0 with itself.
    """
    pos = _find_key_planes(cfg, rows, qkeys)
    pos_c = pos.clamp_min(0)
    item = _take_lane(rows, pos_c)
    if cfg.policy == POLICY_SET_LRU:
        lo = torch.zeros_like(pos_c)
    else:
        lo = get_update_lo(pos_c, cfg.p)
    new_rows, _ = _rotate_insert_planes(rows, lo, pos_c, item)
    return new_rows, pos >= 0, _values(cfg, item), pos


def _empty_ev_planes(cfg: MSLRUConfig, like):
    """Sentinel eviction record: key planes EMPTY_KEY, all other planes 0."""
    col = torch.arange(like.shape[-1], device=like.device)
    return torch.where(col < cfg.key_planes, EMPTY_KEY, 0).to(torch.int32).expand_as(like)


def row_put(cfg: MSLRUConfig, rows, new_key, new_val, new_cost=None):
    """put: insert a (known-absent) item; fill the deepest hole or evict.

    new_key (B, KP), new_val (B, V), new_cost (B,) int32 (read only with a
    cost plane; None inserts cost 0).  The victim of a full set is lane A-1
    unless the config carries a cost plane: then it is the cheapest lane of
    the last vector (the whole set under set_lru), ties to the deepest lane.
    Returns (new_rows, displaced (B, C), evicted_valid).
    """
    e = _find_deepest_empty_planes(rows)
    if cfg.cost_planes:
        lane = _lane(rows)
        ccol = rows[..., cfg.key_planes + cfg.value_planes]
        seg_lo = 0 if cfg.policy == POLICY_SET_LRU else (cfg.m - 1) * cfg.p
        cand = torch.where(lane >= seg_lo, ccol, INT32_MAX)
        cmin = cand.amin(dim=-1)
        victim = _max_lane(cand == cmin[..., None])
    else:
        victim = torch.full_like(e, cfg.assoc - 1)
    pos_ins = torch.where(e >= 0, e, victim)
    if cfg.policy == POLICY_SET_LRU:
        lo = torch.zeros_like(pos_ins)
    else:
        lo = (pos_ins // cfg.p) * cfg.p
    parts = [new_key]
    if cfg.value_planes:
        parts.append(new_val)
    if cfg.cost_planes:
        qc = (torch.zeros(new_key.shape[:-1], dtype=torch.int32, device=rows.device)
              if new_cost is None else new_cost.to(torch.int32))
        parts.append(qc[..., None])
    item = torch.cat(parts, dim=-1).to(torch.int32)
    new_rows, displaced = _rotate_insert_planes(rows, lo, pos_ins, item)
    return new_rows, displaced, displaced[..., 0] != EMPTY_KEY


def row_access_ev(cfg: MSLRUConfig, rows, qkeys, qvals, costs=None):
    """row_access that also returns the full (B, C) eviction record ``ev``
    (the displaced planes of an evicting put, the EMPTY sentinel row
    elsewhere), the same contract as the kernels' C-wide ev output."""
    got_rows, hit, value, pos = row_get(cfg, rows, qkeys)
    put_rows, displaced, ev_ok = row_put(cfg, rows, qkeys, qvals, costs)
    new_rows = torch.where(hit[..., None, None], got_rows, put_rows)
    ev = torch.where(hit[..., None], _empty_ev_planes(cfg, displaced), displaced)
    kp, v = cfg.key_planes, cfg.value_planes
    res = AccessResult(hit=hit, value=value, pos=pos,
                       evicted_key=ev[..., :kp], evicted_val=ev[..., kp:kp + v],
                       evicted_valid=ev_ok & ~hit)
    return new_rows, res, ev


def row_access(cfg: MSLRUConfig, rows, qkeys, qvals, costs=None):
    """The paper's benchmark op: get, and on miss put (key, val).

    Returns (new_rows, AccessResult).
    """
    new_rows, res, _ = row_access_ev(cfg, rows, qkeys, qvals, costs)
    return new_rows, res


def row_delete(cfg: MSLRUConfig, rows, qkeys):
    """delete: invalidate in place (paper §III.B); no compaction."""
    pos = _find_key_planes(cfg, rows, qkeys)
    hit = pos >= 0
    kill = (_lane(rows) == pos[..., None]) & hit[..., None]
    new_rows = rows.clone()
    new_rows[..., 0] = torch.where(kill, EMPTY_KEY, rows[..., 0])
    return new_rows, hit


def row_apply_ev(cfg: MSLRUConfig, rows, qkeys, qvals, ops, chain_live=None,
                 costs=None):
    """Branch-free mixed-op transition: the per-row opcode selects the op.

    rows (B, A, C); qkeys (B, KP); qvals (B, V); ops (B,) OP_* codes;
    chain_live (B,) execute mask for CHAIN_GET/CHAIN_PUT rows (None treats
    every chain row as live); costs (B,) insert costs (cost plane only).
    One result contract for every engine:

      * hit/pos/value come from the probe for LOOKUP/GET/ACCESS and live
        chain rows; DELETE reports hit (found) but pos = -1 and value = 0;
        a dead chain row reports a plain miss,
      * ev / evicted_* fire only for an evicting ACCESS or live-CHAIN_PUT
        insert; elsewhere evicted_key carries the EMPTY_KEY sentinel.

    Returns (new_rows, AccessResult, ev (B, C)).
    """
    is_acc = ops == OP_ACCESS
    is_del = ops == OP_DELETE
    is_look = ops == OP_LOOKUP
    is_chain = (ops == OP_CHAIN_GET) | (ops == OP_CHAIN_PUT)
    if chain_live is None:
        dead = torch.zeros_like(is_chain)
    else:
        dead = is_chain & ~chain_live.to(torch.bool)
    is_putop = is_acc | ((ops == OP_CHAIN_PUT) & ~dead)

    got_rows, hit, value, pos = row_get(cfg, rows, qkeys)
    put_rows, displaced, ev_ok = row_put(cfg, rows, qkeys, qvals, costs)
    del_rows, _ = row_delete(cfg, rows, qkeys)

    evicting = is_putop & ~hit
    acc_or_get = torch.where(evicting[..., None, None], put_rows, got_rows)
    new_rows = torch.where(
        is_del[..., None, None], del_rows,
        torch.where((is_look | dead)[..., None, None], rows, acc_or_get))

    zero_out = is_del | dead
    ev = torch.where(evicting[..., None], displaced, _empty_ev_planes(cfg, displaced))
    kp, v = cfg.key_planes, cfg.value_planes
    res = AccessResult(
        hit=hit & ~dead,
        value=torch.where(zero_out[..., None], 0, value),
        pos=torch.where(zero_out, -1, pos),
        evicted_key=ev[..., :kp],
        evicted_val=ev[..., kp:kp + v],
        evicted_valid=evicting & ev_ok,
    )
    return new_rows, res, ev


def row_apply(cfg: MSLRUConfig, rows, qkeys, qvals, ops, chain_live=None,
              costs=None):
    """row_apply_ev without the ev record (the engine API)."""
    new_rows, res, _ = row_apply_ev(cfg, rows, qkeys, qvals, ops, chain_live, costs)
    return new_rows, res
