"""Pure-Python reference policies (port of ``repro.core.policies``).

The port's own copy, in Python and numpy, as ``repro_torch.data.ycsb`` is:
the algorithms are the JAX package's, line for line.  Two roles:
 1. **Oracles** — `MultiStepLRUOracle` mirrors the engines bit-for-bit
    (same fmix32 set assignment, same deepest-empty insertion, same
    promote/upgrade rules) for equivalence testing against
    ``MultiStepLRUCache`` on the CPU and through the CUDA kernels.
 2. **Baselines** — the algorithms the paper compares against: exact LRU
    (doubly-linked list via OrderedDict), GCLOCK (4-bit reference counters),
    ARC, FIFO, plus a Mattson reuse-distance analyzer that yields the exact
    LRU hit ratio for *every* cache size in one pass (used by Fig. 7).

All baselines expose ``access(key) -> bool`` with the paper's benchmark
semantics: lookup; on miss, insert (evicting if full).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

__all__ = [
    "fmix32_py",
    "fmix64_py",
    "OP_ACCESS",
    "OP_GET",
    "OP_DELETE",
    "OP_LOOKUP",
    "OP_CHAIN_GET",
    "OP_CHAIN_PUT",
    "chain_exec_py",
    "MultiStepLRUOracle",
    "ExactLRU",
    "GClock",
    "ARC",
    "FIFO",
    "ReuseDistanceLRU",
]

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# Mirrors of the engine opcodes (core/multistep.py), kept as literals as the
# JAX package keeps them; equality is asserted in tests.
OP_ACCESS = 0
OP_GET = 1
OP_DELETE = 2
OP_LOOKUP = 3
OP_CHAIN_GET = 4
OP_CHAIN_PUT = 5


def chain_exec_py(ops, chain_ids, raw_hit):
    """Pure-Python mirror of ``engine.chain_exec_from_hits``.

    ops/chain_ids/raw_hit: length-n sequences.  CHAIN_GET row i executes iff
    its contiguous chain run has no raw miss at or before i; the o-th
    CHAIN_PUT row of a chain executes iff o >= the chain's hit length.
    Non-chain rows break runs, exactly like the jnp segmented scan.
    """
    n = len(ops)
    ex = [bool(op not in (OP_CHAIN_GET, OP_CHAIN_PUT)) for op in ops]
    hitlen: dict = {}
    cur_id = object()
    seg_bad = False
    for i in range(n):
        if ops[i] in (OP_CHAIN_GET, OP_CHAIN_PUT):
            c = chain_ids[i]
            if c != cur_id:
                cur_id, seg_bad = c, False
            if ops[i] == OP_CHAIN_GET:
                seg_bad = seg_bad or not raw_hit[i]
                ex[i] = not seg_bad
                if ex[i]:
                    hitlen[c] = hitlen.get(c, 0) + 1
        else:
            cur_id = object()
    occ: dict = {}
    for i in range(n):
        if ops[i] == OP_CHAIN_PUT:
            c = chain_ids[i]
            o = occ.get(c, 0)
            occ[c] = o + 1
            ex[i] = o >= hitlen.get(c, 0)
    return ex


def fmix32_py(x: int) -> int:
    """Python mirror of hashing.fmix32 (uint32 semantics)."""
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    x ^= x >> 16
    return x


def fmix64_py(x: int) -> int:
    """Python mirror of hashing.fmix64_planes (uint64 semantics)."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _MASK64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _MASK64
    x ^= x >> 33
    return x


EMPTY = None  # oracle-side empty slot marker


class MultiStepLRUOracle:
    """Pure-Python multi-step LRU, slot-exact mirror of multistep.py.

    Each set is a flat list of A = M*P slots ordered hot->cold; slot value is
    (key, val) or None.  ``policy='set_lru'`` gives exact-LRU-within-set.
    ``key_planes=2`` models the paper's 64-bit keys: a key is then an
    ``(hi, lo)`` pair of int32 plane values, hashed with fmix64 exactly like
    ``multistep.set_index_for``.
    """

    def __init__(self, num_sets: int, m: int = 2, p: int = 4,
                 policy: str = "multistep", key_planes: int = 1,
                 cost_planes: int = 0):
        assert num_sets & (num_sets - 1) == 0
        self.s, self.m, self.p = num_sets, m, p
        self.a = m * p
        self.policy = policy
        self.key_planes = key_planes
        self.cost_planes = cost_planes
        # Slots are (key, val, cost) triples; cost is carried (and read by
        # the put victim choice) only when cost_planes, but always stored so
        # rotations stay shape-oblivious like the plane rotation on device.
        self.sets = [[None] * self.a for _ in range(num_sets)]

    # -- internals ----------------------------------------------------------
    def set_index(self, key) -> int:
        if self.key_planes == 2:
            hi, lo = key
            h = fmix64_py(((hi & _MASK32) << 32) | (lo & _MASK32))
            return h & _MASK32 & (self.s - 1)
        return fmix32_py(key) & (self.s - 1)

    def _find(self, row, key) -> int:
        for i, slot in enumerate(row):
            if slot is not None and slot[0] == key:
                return i
        return -1

    def _rotate_insert(self, row, lo, hi, item):
        displaced = row[hi]
        for j in range(hi, lo, -1):
            row[j] = row[j - 1]
        row[lo] = item
        return displaced

    # -- operations ---------------------------------------------------------
    def lookup(self, key: int):
        row = self.sets[self.set_index(key)]
        i = self._find(row, key)
        return (True, row[i][1], i) if i >= 0 else (False, None, -1)

    def get(self, key: int):
        """Probe + recency update. Returns (hit, value, pos)."""
        row = self.sets[self.set_index(key)]
        pos = self._find(row, key)
        if pos < 0:
            return False, None, -1
        val = row[pos][1]
        if self.policy == "set_lru":
            lo = 0
        else:
            in_vec = pos % self.p
            lo = (pos // self.p) * self.p if in_vec > 0 else max(pos - 1, 0)
        self._rotate_insert(row, lo, pos, row[pos])
        return True, val, pos

    def put(self, key: int, val, cost: int = 0):
        """Insert known-absent key. Returns (evicted_key, evicted_val) or
        None; with cost_planes the triple (key, val, cost) is returned.

        Victim for a full set: lane A-1, unless cost_planes — then the
        cheapest lane of the eviction-candidate segment (last vector; whole
        set under set_lru), ties broken toward the deepest lane so uniform
        costs degenerate to lane A-1 (mirrors multistep.row_put).
        """
        row = self.sets[self.set_index(key)]
        e = -1
        for i in range(self.a - 1, -1, -1):  # deepest empty slot
            if row[i] is None:
                e = i
                break
        if e >= 0:
            pos_ins = e
        elif self.cost_planes:
            seg_lo = 0 if self.policy == "set_lru" else (self.m - 1) * self.p
            best, pos_ins = None, self.a - 1
            for i in range(seg_lo, self.a):
                c = row[i][2]
                if best is None or c <= best:  # <=: deepest lane wins ties
                    best, pos_ins = c, i
        else:
            pos_ins = self.a - 1
        lo = 0 if self.policy == "set_lru" else (pos_ins // self.p) * self.p
        displaced = self._rotate_insert(row, lo, pos_ins, (key, val, cost))
        if displaced is None:
            return None  # a hole absorbed the insert
        return displaced if self.cost_planes else displaced[:2]

    def access(self, key: int, val=0, cost: int = 0):
        """get; on miss put. Returns (hit, pos, evicted)."""
        hit, _, pos = self.get(key)
        if hit:
            return True, pos, None
        return False, -1, self.put(key, val, cost)

    def delete(self, key: int) -> bool:
        row = self.sets[self.set_index(key)]
        pos = self._find(row, key)
        if pos < 0:
            return False
        row[pos] = None
        return True

    def apply(self, op: int, key, val=0, cost: int = 0) -> dict:
        """Opcode dispatch with the engines' normalized result contract
        (see the table in core/engine.py): returns a dict with ``hit``,
        ``pos`` (-1 for DELETE and misses), ``value`` (None unless a
        non-DELETE hit), and ``evicted`` ((key, val) for an evicting ACCESS
        insert, else None)."""
        if op == OP_LOOKUP:
            hit, value, pos = self.lookup(key)
            return {"hit": hit, "pos": pos, "value": value, "evicted": None}
        if op == OP_GET:
            hit, value, pos = self.get(key)
            return {"hit": hit, "pos": pos, "value": value, "evicted": None}
        if op == OP_DELETE:
            hit = self.delete(key)
            return {"hit": hit, "pos": -1, "value": None, "evicted": None}
        assert op == OP_ACCESS, op
        hit, value, pos = self.get(key)
        if hit:
            return {"hit": True, "pos": pos, "value": value, "evicted": None}
        return {"hit": False, "pos": -1, "value": None,
                "evicted": self.put(key, val, cost)}

    def apply_batch(self, ops, keys, vals=None, chain_ids=None, costs=None):
        """Apply one batch with the engines' chain semantics (list of
        ``apply`` result dicts).  Chain rows probe membership against the
        *batch-start* table, the segmented longest-prefix scan derives each
        row's execute mask (``chain_exec_py``), and a live CHAIN_GET /
        CHAIN_PUT then runs as GET / ACCESS while a downgraded row is a
        reported-miss no-op — the normative contract in core/engine.py."""
        n = len(ops)
        if vals is None:
            vals = [0] * n
        if costs is None:
            costs = [0] * n
        if chain_ids is None:
            ex = [True] * n
        else:
            raw = [self.lookup(k)[0] for k in keys]  # before any mutation
            ex = chain_exec_py(ops, chain_ids, raw)
        miss = {"hit": False, "pos": -1, "value": None, "evicted": None}
        out = []
        for i in range(n):
            op = int(ops[i])
            if op == OP_CHAIN_GET:
                out.append(self.apply(OP_GET, keys[i], vals[i])
                           if ex[i] else dict(miss))
            elif op == OP_CHAIN_PUT:
                out.append(self.apply(OP_ACCESS, keys[i], vals[i], costs[i])
                           if ex[i] else dict(miss))
            else:
                out.append(self.apply(op, keys[i], vals[i], costs[i]))
        return out

    def dump_keys(self) -> np.ndarray:
        """(S, A) int64 key matrix with EMPTY as a large negative sentinel."""
        out = np.full((self.s, self.a), -(2**31), np.int64)
        for si, row in enumerate(self.sets):
            for ai, slot in enumerate(row):
                if slot is not None:
                    out[si, ai] = slot[0]
        return out


class ExactLRU:
    """Global exact LRU over an OrderedDict (the paper's linked-list baseline)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.od: OrderedDict = OrderedDict()

    def access(self, key: int) -> bool:
        od = self.od
        if key in od:
            od.move_to_end(key)
            return True
        if len(od) >= self.capacity:
            od.popitem(last=False)
        od[key] = True
        return False

    def delete(self, key: int) -> bool:
        return self.od.pop(key, None) is not None


class GClock:
    """Generalized CLOCK with a capped reference counter (paper: 4 bits).

    Hit: increment counter (saturating at cap).  Miss: advance the hand,
    decrementing positive counters, until a zero-counter slot is found;
    evict it and insert the new key there with counter 0.
    """

    def __init__(self, capacity: int, cap: int = 15):
        self.capacity = capacity
        self.cap = cap
        self.keys = [None] * capacity
        self.count = np.zeros(capacity, np.int32)
        self.hand = 0
        self.index: dict = {}
        self.size = 0

    def access(self, key: int) -> bool:
        slot = self.index.get(key)
        if slot is not None:
            if self.count[slot] < self.cap:
                self.count[slot] += 1
            return True
        if self.size < self.capacity:
            slot = self.size
            self.size += 1
        else:
            while True:
                h = self.hand
                self.hand = (h + 1) % self.capacity
                if self.count[h] == 0:
                    slot = h
                    break
                self.count[h] -= 1
            del self.index[self.keys[slot]]
        self.keys[slot] = key
        self.count[slot] = 0
        self.index[key] = slot
        return False


class ARC:
    """Adaptive Replacement Cache (Megiddo & Modha, FAST'03).

    T1/T2 are the resident lists (recency / frequency), B1/B2 the ghost
    lists; ``p`` is the adaptive target size of T1.  Exposes which list a
    hit landed in (for the Fig. 12 breakdown).
    """

    def __init__(self, capacity: int):
        self.c = capacity
        self.p = 0
        self.t1: OrderedDict = OrderedDict()
        self.t2: OrderedDict = OrderedDict()
        self.b1: OrderedDict = OrderedDict()
        self.b2: OrderedDict = OrderedDict()
        self.last_hit_list: Optional[str] = None

    def _replace(self, in_b2: bool):
        if self.t1 and (len(self.t1) > self.p or (in_b2 and len(self.t1) == self.p)):
            k, _ = self.t1.popitem(last=False)
            self.b1[k] = True
        else:
            k, _ = self.t2.popitem(last=False)
            self.b2[k] = True

    def access(self, key: int) -> bool:
        if key in self.t1:
            del self.t1[key]
            self.t2[key] = True
            self.last_hit_list = "t1"
            return True
        if key in self.t2:
            self.t2.move_to_end(key)
            self.last_hit_list = "t2"
            return True
        self.last_hit_list = None
        if key in self.b1:
            self.p = min(self.c, self.p + max(1, len(self.b2) // max(1, len(self.b1))))
            self._replace(False)
            del self.b1[key]
            self.t2[key] = True
            return False
        if key in self.b2:
            self.p = max(0, self.p - max(1, len(self.b1) // max(1, len(self.b2))))
            self._replace(True)
            del self.b2[key]
            self.t2[key] = True
            return False
        l1 = len(self.t1) + len(self.b1)
        if l1 == self.c:
            if len(self.t1) < self.c:
                self.b1.popitem(last=False)
                self._replace(False)
            else:
                self.t1.popitem(last=False)
        elif l1 < self.c and len(self.t1) + len(self.t2) + len(self.b1) + len(self.b2) >= self.c:
            if len(self.t1) + len(self.t2) + len(self.b1) + len(self.b2) >= 2 * self.c:
                self.b2.popitem(last=False)
            self._replace(False)
        self.t1[key] = True
        return False


class FIFO:
    """First-in first-out baseline."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.od: OrderedDict = OrderedDict()

    def access(self, key: int) -> bool:
        if key in self.od:
            return True
        if len(self.od) >= self.capacity:
            self.od.popitem(last=False)
        self.od[key] = True
        return False


class ReuseDistanceLRU:
    """Mattson stack algorithm: exact-LRU hit counts for all sizes at once.

    Feed the full trace; ``hits_for(size)`` then answers any capacity.
    Implementation: Fenwick tree over last-access positions; the reuse
    distance of an access is the number of *distinct* keys touched since the
    key's previous access, which is exactly its LRU stack depth.
    """

    def __init__(self, max_trace_len: int):
        self.n = max_trace_len + 1
        self.bit = np.zeros(self.n + 1, np.int64)
        self.last: dict = {}
        self.t = 0
        self.dist_hist: dict = {}
        self.cold = 0

    def _add(self, i: int, v: int):
        i += 1
        while i <= self.n:
            self.bit[i] += v
            i += i & (-i)

    def _sum(self, i: int) -> int:
        i += 1
        s = 0
        while i > 0:
            s += self.bit[i]
            i -= i & (-i)
        return int(s)

    def access(self, key: int):
        prev = self.last.get(key)
        if prev is None:
            self.cold += 1
        else:
            d = self._sum(self.t) - self._sum(prev)  # distinct keys since prev
            self.dist_hist[d] = self.dist_hist.get(d, 0) + 1
            self._add(prev, -1)
        self._add(self.t, 1)
        self.last[key] = self.t
        self.t += 1

    def feed(self, trace):
        for k in trace:
            self.access(int(k))

    def hits_for(self, size: int) -> int:
        return sum(c for d, c in self.dist_hist.items() if d <= size)

    def hit_ratio(self, size: int) -> float:
        return self.hits_for(size) / max(1, self.t)
