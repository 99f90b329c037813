"""Mixed-op batches and the comparison of the port's cache engines with the
port's Python oracle (``repro_torch.core.policies.MultiStepLRUOracle``).

numpy and the port only, no JAX, so that ``chip_smoke.py`` phase 25 runs the
same batches and checks through the CUDA kernels that the CPU tests run
through the plain versions.

A batch mixes single ACCESS / GET / DELETE / LOOKUP rows with prefix-cache
chains laid out as the serving tick lays them out: a chain's run of
CHAIN_GET rows over its chunk keys, then its run of CHAIN_PUT rows over the
same keys with values, both under the chain's id.  Keys repeat within a
batch (same-set conflict chains) and across batches (hits, promotions,
upgrades), and costs tie often.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.invector import EMPTY_KEY
from repro_torch.core.policies import (OP_ACCESS, OP_CHAIN_GET, OP_CHAIN_PUT,
                                       OP_DELETE, OP_GET, OP_LOOKUP,
                                       MultiStepLRUOracle)

SINGLE_OPS = np.array([OP_ACCESS, OP_ACCESS, OP_ACCESS, OP_GET, OP_DELETE, OP_LOOKUP],
                      np.int32)


def draw_keys(rng, cfg, n: int, key_range: int) -> np.ndarray:
    """(n, KP) int32 keys in [1, key_range]: half from a hot eighth of the
    range.  With two key planes the high plane takes 4 values."""
    hot = rng.random(n) < 0.5
    lo = np.where(hot, rng.integers(1, max(2, key_range // 8), n),
                  rng.integers(1, key_range + 1, n)).astype(np.int32)
    if cfg.key_planes == 1:
        return lo[:, None]
    return np.stack([rng.integers(0, 4, n).astype(np.int32), lo], axis=1)


def mixed_batch(rng, cfg, n: int, key_range: int, chain_share: float = 0.4,
                max_chain: int = 6) -> dict:
    """One batch of n mixed rows: ``keys`` (n, KP), ``vals`` (n, V),
    ``ops``, ``chain_ids`` and ``costs`` (n,), all int32."""
    pool = draw_keys(rng, cfg, n, key_range)
    ops, rows, cids = [], [], []
    chain = 0
    i = 0
    while len(ops) < n:
        if rng.random() < chain_share and n - len(ops) >= 2:
            length = int(rng.integers(1, max_chain + 1))
            length = min(length, (n - len(ops)) // 2)
            members = list(range(i, i + length))
            i += length
            chain += 1
            for op in (OP_CHAIN_GET, OP_CHAIN_PUT):
                ops += [op] * length
                rows += members
                cids += [chain] * length
        else:
            ops.append(int(rng.choice(SINGLE_OPS)))
            rows.append(i)
            cids.append(0)
            i += 1
    rows = np.asarray(rows) % n
    vals = rng.integers(-2**30, 2**30, (n, cfg.value_planes)).astype(np.int32)
    return {"keys": np.ascontiguousarray(pool[rows]),
            "vals": vals.reshape(n, cfg.value_planes),
            "ops": np.asarray(ops, np.int32),
            "chain_ids": np.asarray(cids, np.int32),
            "costs": rng.integers(0, 4, n).astype(np.int32)}


def oracle_for(cfg) -> MultiStepLRUOracle:
    return MultiStepLRUOracle(cfg.num_sets, cfg.m, cfg.p, policy=cfg.policy,
                              key_planes=cfg.key_planes, cost_planes=cfg.cost_planes)


def oracle_key(cfg, krow):
    return tuple(int(x) for x in krow) if cfg.key_planes == 2 else int(krow[0])


def apply_oracle(oracle, cfg, batch) -> list:
    """``oracle.apply_batch`` of a batch: one record per row."""
    keys = [oracle_key(cfg, k) for k in batch["keys"].tolist()]
    vals = [tuple(v) for v in batch["vals"].tolist()]
    costs = batch["costs"].tolist() if cfg.cost_planes else None
    return oracle.apply_batch(batch["ops"].tolist(), keys, vals,
                              batch["chain_ids"].tolist(), costs)


def records_arrays(cfg, recs) -> dict:
    """The records as the engines' AccessResult arrays, with the masks of
    the rows where a field is defined (``value`` on a hit that is not a
    DELETE; the evicted item where one was evicted)."""
    n, kp, v = len(recs), cfg.key_planes, cfg.value_planes
    out = {"hit": np.zeros(n, bool), "pos": np.full(n, -1, np.int32),
           "value": np.zeros((n, v), np.int64), "value_mask": np.zeros(n, bool),
           "evicted_valid": np.zeros(n, bool), "evicted_key": np.zeros((n, kp), np.int64),
           "evicted_val": np.zeros((n, v), np.int64)}
    for i, r in enumerate(recs):
        out["hit"][i] = r["hit"]
        out["pos"][i] = r["pos"]
        if r["value"] is not None:
            out["value_mask"][i] = True
            out["value"][i] = r["value"]
        ev = r["evicted"]
        if ev is not None:
            out["evicted_valid"][i] = True
            out["evicted_key"][i] = ev[0] if kp == 2 else (ev[0],)
            out["evicted_val"][i] = ev[1]
    return out


def mismatches(cfg, recs, res) -> dict:
    """Rows where an engine's result (numpy arrays of an AccessResult)
    differs from the oracle's records, by field: ``hit``, ``pos``,
    ``value`` (on defined rows), ``evicted_valid``, and the evicted
    ``evicted_key`` / ``evicted_val`` where one was evicted."""
    want = records_arrays(cfg, recs)
    got = {f: np.asarray(getattr(res, f)) for f in
           ("hit", "pos", "value", "evicted_key", "evicted_val", "evicted_valid")}
    ev = want["evicted_valid"]
    bad = {"hit": got["hit"].astype(bool) != want["hit"],
           "pos": got["pos"] != want["pos"],
           "value": want["value_mask"] & (got["value"] != want["value"]).any(axis=1),
           "evicted_valid": got["evicted_valid"].astype(bool) != ev,
           "evicted_key": ev & (got["evicted_key"] != want["evicted_key"]).any(axis=1),
           "evicted_val": ev & (got["evicted_val"] != want["evicted_val"]).any(axis=1)}
    return {f: np.flatnonzero(m)[:8].tolist() for f, m in bad.items() if m.any()}


def table_mismatch(cfg, oracle, table: np.ndarray) -> list:
    """Slots where a (S, A, C) table's keys differ from the oracle's
    (``dump_keys``; with two key planes, each plane of the occupied
    slots): [(set, lane)], at most 8."""
    keys = table[:, :, :cfg.key_planes].astype(np.int64)
    if cfg.key_planes == 1:
        bad = keys[:, :, 0] != oracle.dump_keys()
    else:
        want = np.full(keys.shape, 0, np.int64)
        want[:, :, 0] = EMPTY_KEY
        for si, row in enumerate(oracle.sets):
            for ai, slot in enumerate(row):
                if slot is not None:
                    want[si, ai] = slot[0]
        occupied = want[:, :, 0] != EMPTY_KEY
        bad = (keys[:, :, 0] != want[:, :, 0]) | (occupied
                                                  & (keys[:, :, 1] != want[:, :, 1]))
    return [tuple(x) for x in np.argwhere(bad)[:8].tolist()]
