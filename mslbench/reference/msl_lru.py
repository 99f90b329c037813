"""Plain reference of the multi-step LRU cache, for the cache cell's check.

The semantics are the paper's (Multi-step LRU, §III.B) for a set of
A = M·P lanes ordered hot to cold, the victim always the last lane:

* ``access(key, value)`` probes the set's row.  A hit at lane ``pos``
  moves the item to the start of its vector (``pos % P > 0``), or, from
  the start of a vector, one lane up into the previous vector's last lane
  (lane 0 stays); the lanes in between shift down by one.
* A miss inserts (key, value) at the start of the vector that holds the
  deepest empty lane, or else the last lane, whose item is evicted; the
  lanes in between shift down by one.
* Queries to one set are applied one at a time in stream order; a batch
  is the stream cut into pieces, so a set's outcome depends only on its
  own queries, in order.  The reference therefore replays only a sample
  of sets, each over the whole stream that the run sent.

A key is assigned to set ``fmix32(key) & (S - 1)``.  Nothing here comes
from the program: set ids, rows and results are all worked out again.

``transition`` is written once for numpy (the replay) and torch (the
control, ``control.py``, which runs it over a whole batch on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mslbench.reference.murmur import as_int32, fmix32

EMPTY = -(2**31)


def set_of(keys, num_sets: int):
    return fmix32(keys) & (num_sets - 1)


def value_of(keys):
    """The 64-bit value the cache cell stores for a key, as two int32
    planes: the key itself and a hash of it.  A hit's value is checked
    against it."""
    if isinstance(keys, np.ndarray):
        k = keys.astype(np.int64)
        return np.stack([k, as_int32(fmix32(k ^ 0x5BD1E995))], -1).astype(np.int32)
    import torch
    k = keys.to(torch.int64)
    return torch.stack([k, as_int32(fmix32(k ^ 0x5BD1E995))], -1).to(torch.int32)


def _ops(x):
    """numpy or torch spellings of the few calls that differ."""
    if isinstance(x, np.ndarray):
        return (lambda a, n: np.arange(n)), (lambda a: np.roll(a, 1, axis=1)), \
            (lambda a: a.max(axis=1)), (lambda a: a.astype(np.int64).argmax(axis=1))
    import torch
    return ((lambda a, n: torch.arange(n, device=a.device)),
            (lambda a: torch.roll(a, 1, dims=1)), (lambda a: a.amax(dim=1)),
            (lambda a: a.to(torch.int64).argmax(dim=1)))


def transition(keys, vals, qk, qv, m: int, p: int):
    """One access per row: rows ``keys`` (n, A), ``vals`` (n, A, V), query
    keys ``qk`` (n,) and values ``qv`` (n, V).  Returns the new rows and
    the per-query outcome: hit, pos (-1 on a miss), value (the stored value
    on a hit), the evicted key (EMPTY unless an item left), its value (0
    unless one left), whether one left, and the lane the key ends in."""
    arange, roll, rowmax, argmax = _ops(keys)
    w = m * p
    lane = arange(keys, w)[None, :]
    r = arange(keys, keys.shape[0])
    match = keys == qk[:, None]
    hit = match.any(1)
    pos = argmax(match)
    deepest_empty = rowmax((keys == EMPTY) * (lane + 1)) - 1
    ins = deepest_empty + (deepest_empty < 0) * (w - 1 - deepest_empty)  # full: lane w-1
    hi = hit * pos + ~hit * ins
    lo_hit = (pos % p > 0) * (pos // p * p) + (pos % p == 0) * (pos - 1) * (pos > 0)
    lo = hit * lo_hit + ~hit * (ins // p * p)
    disp_k, disp_v = keys[r, hi], vals[r, hi]
    item_v = hit[:, None] * disp_v + ~hit[:, None] * qv
    at_lo = lane == lo[:, None]
    mid = (lane > lo[:, None]) & (lane <= hi[:, None])
    new_k = at_lo * qk[:, None] + mid * roll(keys) + ~(at_lo | mid) * keys
    new_v = (at_lo[..., None] * item_v[:, None, :] + mid[..., None] * roll(vals)
             + ~(at_lo | mid)[..., None] * vals)
    ev_valid = ~hit & (disp_k != EMPTY)
    out = {"hit": hit, "pos": hit * pos - ~hit * 1,
           "value": hit[:, None] * disp_v,
           "evicted_key": hit * EMPTY + ~hit * disp_k,
           "evicted_val": ~hit[:, None] * disp_v,
           "evicted_valid": ev_valid, "lane": lo}
    return new_k, new_v, out


@dataclasses.dataclass
class SetStream:
    """One sampled set's queries in one pass over the query pool: their
    pool positions (ascending), keys and values."""

    positions: np.ndarray   # (n,) int64
    keys: np.ndarray        # (n,) int32
    values: np.ndarray      # (n, V) int32


class Replay:
    """The sampled sets, each replayed over the stream the run sent: the
    pool walked in order ``passes`` whole times and then up to pool
    position ``rest``.  A run of one key is replayed for its first
    ``cap`` queries; the rest are hits in lane 0 that change nothing
    (checked: the run's key must stand in lane 0 by then)."""

    def __init__(self, streams: list[SetStream], passes: int, rest: int, *,
                 m: int, p: int, value_planes: int):
        self.m, self.p = m, p
        self.cap = 2 * m - 1 if p > 1 else m * p + 1
        self.streams = streams
        runs = [self._runs(s, passes, rest) for s in streams]
        n, w = len(streams), m * p
        length = max([len(rk) for rk, *_ in runs] + [0])
        self.run_start = [r[1] for r in runs]       # first occurrence of each run
        self.run_mem = [r[3] for r in runs]         # first member of each run
        self.run_len = [r[2] for r in runs]
        keys = np.full((n, w), EMPTY, np.int64)
        vals = np.zeros((n, w, value_planes), np.int64)
        mk = np.zeros((n, length), np.int64)
        mv = np.zeros((n, length, value_planes), np.int64)
        live = np.zeros((n, length), bool)
        for i, (k, _, _, _, v) in enumerate(runs):
            mk[i, :len(k)], mv[i, :len(k)], live[i, :len(k)] = k, v, True
        self.out = {name: np.zeros((n, length) + shape, np.int64) for name, shape in
                    (("hit", ()), ("pos", ()), ("value", (value_planes,)),
                     ("evicted_key", ()), ("evicted_val", (value_planes,)),
                     ("evicted_valid", ()), ("lane", ()))}
        for t in range(length):
            nk, nv, o = transition(keys, vals, mk[:, t], mv[:, t], m, p)
            on = live[:, t]
            keys[on], vals[on] = nk[on], nv[on]
            for name, x in o.items():
                self.out[name][:, t] = x
        self.keys, self.vals = keys, vals

    def _runs(self, s: SetStream, passes: int, rest: int):
        """The set's member queries: each run of one key cut to ``cap``."""
        n = len(s.keys)
        part = int(np.searchsorted(s.positions, rest))
        occ_keys = s.keys.astype(np.int64)
        heads = np.flatnonzero(np.r_[True, occ_keys[1:] != occ_keys[:-1]]) if n else np.zeros(0, int)
        starts, keys = [], []
        for j in range(passes + 1):
            upto = n if j < passes else part
            h = heads[heads < upto]
            starts.append(j * n + h)
            keys.append(occ_keys[h])
        starts, keys = np.concatenate(starts), np.concatenate(keys)
        total = passes * n + part
        if len(starts):        # a run may go on across the wrap of the pool
            keep = np.r_[True, keys[1:] != keys[:-1]]
            starts, keys = starts[keep], keys[keep]
        lens = np.diff(np.r_[starts, total])
        counts = np.minimum(lens, self.cap)
        mem_first = (np.cumsum(counts) - counts).astype(np.int64)
        occ = np.repeat(starts, counts) + (np.arange(counts.sum()) - np.repeat(mem_first, counts))
        return (np.repeat(keys, counts), starts, lens, mem_first,
                s.values[occ % n].astype(np.int64) if n else np.zeros((0, s.values.shape[1]), np.int64))

    def answers(self, i: int, occurrences: np.ndarray) -> dict:
        """The outcome of set i's queries at these occurrence indices (its
        k-th query of the stream is occurrence k)."""
        starts, lens, mem = self.run_start[i], self.run_len[i], self.run_mem[i]
        r = np.searchsorted(starts, occurrences, side="right") - 1
        d = occurrences - starts[r]
        inside = d < self.cap
        last = mem[r] + np.minimum(lens[r], self.cap) - 1
        idx = np.where(inside, mem[r] + d, last)
        res = {name: x[i][idx].copy() for name, x in self.out.items()}
        capped = ~inside
        if capped.any():
            if (res["lane"][capped] != 0).any():
                raise AssertionError("a run's key is not in lane 0 after the capped replay")
            res["hit"][capped] = 1
            res["pos"][capped] = 0
            res["evicted_key"][capped] = EMPTY
            res["evicted_val"][capped] = 0
            res["evicted_valid"][capped] = 0
        return res
