"""Batches built of long repeated runs, for the one-pass engine.

A run is a stretch of consecutive queries of one set with equal operands
(key, value and cost planes, opcode, chain execute bit, served).  The
one-pass CUDA kernel resolves such a run with one transition once the row
stops changing; these batches exercise every way a run can start, cross a
32-member window and end.  Built with numpy and the port's hash only, so
that both the CPU parity tests (against the JAX engine) and the card tests
(kernel against plain version) import them without JAX.

``run_cases()`` gives ``RunCase`` tuples of numpy arrays: the cache
geometry (``MSLRUConfig`` keyword arguments), a warm table, the batch's
keys, values, valid mask, and optional opcodes, chain execute mask, costs
and ``max_rounds`` cap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import (EMPTY_KEY, MSLRUConfig, OP_ACCESS, OP_CHAIN_GET,
                              OP_CHAIN_PUT, OP_DELETE, OP_GET, OP_LOOKUP,
                              set_index_for)
from repro_torch.data.ycsb import zipfian


class RunCase(NamedTuple):
    name: str
    kw: dict                 # MSLRUConfig keyword arguments
    table: np.ndarray        # (S, A, C) int32, the table before the batch
    keys: np.ndarray         # (B, KP) int32
    vals: np.ndarray         # (B, V) int32
    valid: np.ndarray        # (B,) bool
    ops: np.ndarray | None   # (B,) int32 opcodes
    chain_live: np.ndarray | None  # (B,) int32 chain execute mask
    costs: np.ndarray | None       # (B,) int32
    max_rounds: int | None


def set_ids(cfg: MSLRUConfig, keys: np.ndarray) -> np.ndarray:
    """The port's set id of each (KP,) key row."""
    keys = np.ascontiguousarray(keys.reshape(-1, cfg.key_planes), np.int32)
    return set_index_for(cfg, torch.from_numpy(keys)).numpy()


def keys_in_set(cfg: MSLRUConfig, rng, n: int, sid: int = 0) -> np.ndarray:
    """``n`` distinct (KP,) keys that hash to set ``sid``."""
    out = []
    while len(out) < n:
        cand = np.stack([rng.integers(1, 1 << 20, 64)]
                        + [rng.integers(0, 4, 64)] * (cfg.key_planes - 1), 1)
        cand = cand.astype(np.int32)
        for k in cand[set_ids(cfg, cand) == sid]:
            if not any(np.array_equal(k, o) for o in out):
                out.append(k)
    return np.stack(out[:n])


def warm_table(cfg: MSLRUConfig, rng, pool: np.ndarray, fill: float = 0.75,
               place: dict | None = None) -> np.ndarray:
    """A table holding keys of ``pool`` in the sets they hash to, about
    ``fill`` of each set's lanes used, with random values and small costs;
    ``place`` maps a pool index to the lane its key must sit at."""
    a, c, kp = cfg.assoc, cfg.planes, cfg.key_planes
    table = np.zeros((cfg.num_sets, a, c), np.int32)
    table[:, :, 0] = EMPTY_KEY
    sids = set_ids(cfg, pool)
    place = place or {}
    for s in range(cfg.num_sets):
        members = [i for i in np.flatnonzero(sids == s) if i not in place]
        lanes = list(rng.permutation(a))
        pinned = {i: lane for i, lane in place.items() if sids[i] == s}
        for lane in pinned.values():
            lanes.remove(lane)
        n_free = max(0, int(round(fill * a)) - len(pinned))
        for i, lane in [*pinned.items(), *zip(members[:n_free], lanes)]:
            table[s, lane, :kp] = pool[i]
            table[s, lane, kp:] = rng.integers(-50, 50, c - kp)
            if cfg.cost_planes:
                table[s, lane, -1] = rng.integers(0, 3)
    return table


def _runs(rng, lengths, n_keys, total):
    """Run lengths (cycled) and the pool index of each run's key, with no
    two neighbouring runs on one key, cut to ``total`` queries."""
    idx, lens = [], []
    prev = -1
    i = 0
    while sum(lens) < total:
        k = int(rng.integers(0, n_keys - 1))
        k = k if k < prev or prev < 0 else k + 1
        idx.append(k)
        lens.append(min(lengths[i % len(lengths)], total - sum(lens)))
        prev, i = k, i + 1
    return np.repeat(idx, lens), np.repeat(np.arange(len(lens)), lens)


WINDOW_LENGTHS = [1, 31, 33, 2, 64, 5, 32, 30, 3, 96, 1, 1, 63, 40]


def zipf_hot(seed: int = 0) -> RunCase:
    """A Zipf 0.99 batch at a small table whose hottest key is asked for
    well over 100 times, and sits in the deepest lane of its set when the
    batch starts (its first hits move it up vector by vector)."""
    kw = dict(num_sets=128, m=2, p=4, value_planes=2)
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    keys = zipfian(40, 512, 0.99, seed=seed)[:, None].astype(np.int32)
    uniq, counts = np.unique(keys[:, 0], return_counts=True)
    hot = int(np.argmax(counts))
    assert counts[hot] >= 100, counts.max()
    pool = uniq[:, None].astype(np.int32)
    table = warm_table(cfg, rng, pool, fill=0.6, place={hot: cfg.assoc - 1})
    vals = np.concatenate([keys, -keys], 1).astype(np.int32)
    return RunCase("zipf_hot", kw, table, keys, vals, np.ones(512, bool), None,
                   None, None, None)


def window_runs(seed: int = 1, *, holes: bool = False,
                max_rounds: int | None = None, b: int = 512) -> RunCase:
    """One set's chain of ``b`` members made of runs of 1-96 equal queries
    over 6 keys (2 not in the table), so that runs start, end and carry at
    every offset of a 32-member window; ``holes`` drops about one query in
    40 from the valid mask, breaking runs; ``max_rounds`` caps the chain
    inside a run."""
    kw = dict(num_sets=2, m=2, p=4, value_planes=1)
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    pool = keys_in_set(cfg, rng, 6)
    table = warm_table(cfg, rng, pool[:4], fill=0.5, place={0: 6})
    which, run = _runs(rng, WINDOW_LENGTHS, len(pool), b)
    keys = pool[which]
    vals = (keys[:, :1] * 3 + 1).astype(np.int32)
    valid = rng.random(b) >= 0.025 if holes else np.ones(b, bool)
    name = f"window_runs{'_holes' if holes else ''}{'' if max_rounds is None else f'_cap{max_rounds}'}"
    return RunCase(name, kw, table, keys, vals, valid, None, None, None, max_rounds)


def op_runs(seed: int = 2, b: int = 512) -> RunCase:
    """Runs of every opcode on one set: ACCESS, GET, LOOKUP, DELETE (a hit
    then misses), CHAIN_GET and CHAIN_PUT with runs of dead members (chain
    execute bit 0) and of live ones."""
    kw = dict(num_sets=2, m=2, p=4, value_planes=2)
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    pool = keys_in_set(cfg, rng, 8)
    table = warm_table(cfg, rng, pool[:5], fill=0.75)
    which, run = _runs(rng, [7, 40, 1, 33, 12, 65, 2, 28], len(pool), b)
    kinds = np.array([(OP_ACCESS, 1), (OP_GET, 1), (OP_LOOKUP, 1), (OP_DELETE, 1),
                      (OP_CHAIN_GET, 1), (OP_CHAIN_GET, 0), (OP_CHAIN_PUT, 1),
                      (OP_CHAIN_PUT, 0)], np.int32)
    kind = kinds[rng.integers(0, len(kinds), run.max() + 1)][run]
    keys = pool[which]
    vals = np.stack([keys[:, 0] % 97, run], 1).astype(np.int32)
    return RunCase("op_runs", kw, table, keys, vals, np.ones(b, bool),
                   kind[:, 0].copy(), kind[:, 1].copy(), None, None)


def cost_runs(seed: int = 3, b: int = 512) -> RunCase:
    """Runs on the cost-plane geometry; the cost changes inside some runs
    (a cost is an operand plane, so the run breaks there)."""
    kw = dict(num_sets=2, m=2, p=4, value_planes=1, cost_planes=1)
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    pool = keys_in_set(cfg, rng, 12)
    table = warm_table(cfg, rng, pool[:6], fill=1.0)
    which, run = _runs(rng, [3, 45, 1, 20, 70, 9], len(pool), b)
    keys = pool[which]
    vals = (keys[:, :1] % 1000).astype(np.int32)
    costs = (run % 4 + (np.arange(b) % 29 == 17)).astype(np.int32)
    return RunCase("cost_runs", kw, table, keys, vals, np.ones(b, bool), None,
                   None, costs, None)


def value_runs(seed: int = 4, b: int = 384) -> RunCase:
    """Runs of one key whose values change every few queries or alternate:
    equal keys with unequal values are not one run."""
    kw = dict(num_sets=2, m=2, p=4, value_planes=2)
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    pool = keys_in_set(cfg, rng, 4)
    table = warm_table(cfg, rng, pool[:2], fill=0.5)
    which, run = _runs(rng, [50, 8, 90, 1, 37], len(pool), b)
    keys = pool[which]
    i = np.arange(b)
    step = np.where(run % 2 == 0, i // 5, i % 2)   # every 5th, or alternating
    vals = np.stack([keys[:, 0] % 50 + step, -step], 1).astype(np.int32)
    return RunCase("value_runs", kw, table, keys, vals, np.ones(b, bool), None,
                   None, None, None)


def wide_key_runs(seed: int = 5, b: int = 384) -> RunCase:
    """Runs with two key planes under the set_lru policy, over two sets."""
    kw = dict(num_sets=2, m=4, p=2, key_planes=2, value_planes=1, policy="set_lru")
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys_in_set(cfg, rng, 4, sid=0),
                           keys_in_set(cfg, rng, 4, sid=1)])
    table = warm_table(cfg, rng, pool[::2], fill=0.5)
    which, run = _runs(rng, [12, 1, 44, 33, 3], len(pool), b)
    keys = pool[which]
    vals = (keys[:, :1] % 77).astype(np.int32)
    return RunCase("wide_key_runs", kw, table, keys, vals, np.ones(b, bool), None,
                   None, None, None)


def run_cases() -> list[RunCase]:
    return [zipf_hot(), window_runs(), window_runs(holes=True),
            window_runs(max_rounds=200), window_runs(holes=True, max_rounds=100),
            op_runs(), cost_runs(), value_runs(), wide_key_runs()]
