"""Seeded inputs and runners for the sharded cache, shared by the port's CPU
tests and the JAX children they start.

Numpy only: a child process with D fake JAX devices imports this module to
drive the JAX package's sharded engine and client, the parent test drives
the port's through the same functions, and the two records must be equal.

* ``engine_batches`` — plain and mixed-opcode query batches for
  ``make_sharded_engine``.
* ``chain_batch`` — one serving tick's chain rows, laid out as
  ``PrefixCache.serve_chains`` lays them out (a CHAIN_GET island, then a
  CHAIN_PUT island carrying staged page values).
* ``client_steps`` / ``drive_client`` — a multi-tick sequence of chain
  ticks, plain inserts, lookups and faults (``inject_route_failures``,
  ``mark_degraded``, ``reshard``) for ``ShardedCacheClient``, and the record
  of everything the client reports along the way.
* ``SERVE_CASES`` / ``prompts`` / ``fault_plan`` / ``summary`` — serving
  runs of phi3-mini-smoke behind a D = 2 client: engine and backend
  arguments, fault plans, the request trace, and what a served run reports.
* ``reshard_calls`` / ``drive_reshard`` — ``tests/test_reshard.py``'s
  workload (180 chain accesses under eviction pressure, then a reshard)
  and everything the reshard reports; ``client_state`` — the host state
  every rank of a process mesh must share.
"""

from __future__ import annotations

import numpy as np

# the cache geometry of the client sweeps: 64 sets of M=2 x P=4 ways, one
# value plane (a page index), as the serving tests' prefix caches
CFG = dict(num_sets=64, m=2, p=4, value_planes=1)
ARCH = "phi3-mini-3.8b"
OP_ACCESS, OP_GET, OP_DELETE, OP_LOOKUP, OP_CHAIN_GET, OP_CHAIN_PUT = range(6)

CAPS = ("full", 2.0, 1.0, 0.5)
PLACEMENTS = ("load", "roundrobin", "split")

COUNTERS = ("sheds", "shed_groups", "split_chains", "partial_sheds",
            "slab_occupancy_peak", "degraded_sheds", "fault_sheds")


def _hashes(rng, n: int) -> list[int]:
    """``n`` chunk hashes: odd 31-bit ints, as ``chunk_chain_hashes`` gives."""
    return [(int(h) & 0x7FFFFFFF) | 1 for h in rng.integers(1, 2**31 - 1, n)]


def engine_batches(seed: int, n_batches: int, q: int, mixed: bool,
                   key_range: int = 600):
    """``n_batches`` (keys (q, 1), vals (q, 1), ops (q,) or None) batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        keys = rng.integers(1, key_range, (q, 1)).astype(np.int32)
        ops = rng.integers(0, 4, q).astype(np.int32) if mixed else None
        out.append((keys, keys + 7, ops))
    return out


def chain_batch(chains, staged):
    """(keys, vals (n, 1), ops, chain_ids) of one fused serving tick."""
    keys, vals, ops, cids = [], [], [], []
    for c, chain in enumerate(chains):
        keys += chain
        vals += [0] * len(chain)
        ops += [OP_CHAIN_GET] * len(chain)
        cids += [c] * len(chain)
    for c, (chain, pages) in enumerate(zip(chains, staged)):
        keys += chain[: len(pages)]
        vals += list(pages[: len(chain)])
        ops += [OP_CHAIN_PUT] * min(len(pages), len(chain))
        cids += [c] * min(len(pages), len(chain))
    return (np.asarray(keys, np.int32), np.asarray(vals, np.int32)[:, None],
            np.asarray(ops, np.int32), np.asarray(cids, np.int32))


def client_steps(seed: int, ndev: int, n_ticks: int = 7, reshard_to: int = 1,
                 faults: bool = True):
    """A seeded sequence of client calls: chain ticks over shared templates
    (same-tick duplicates, shared prefixes, chains that miss and insert),
    one plain ACCESS insert batch and one LOOKUP batch, transient route
    failures, a degraded shard (when ``ndev`` >= 2) and a reshard to
    ``reshard_to`` shards two ticks before the end.  ``faults=False`` leaves
    out the degraded shard and the reshard (the same draws otherwise)."""
    rng = np.random.default_rng(seed)
    templates = [_hashes(rng, int(rng.integers(2, 7))) for _ in range(6)]
    page = 1
    steps = []
    for t in range(n_ticks):
        if t == 2:
            steps.append(("route_fail", 2, 0.4, seed + 11))
        if t == 3 and ndev >= 2 and faults:
            steps.append(("degrade", ndev - 1))
        if t == n_ticks - 2 and faults:
            steps.append(("reshard", reshard_to))
        chains = []
        for _ in range(int(rng.integers(3, 7))):
            base = templates[int(rng.integers(len(templates)))]
            cut = int(rng.integers(1, len(base) + 1))
            chains.append(base[:cut] + _hashes(rng, int(rng.integers(0, 3))))
        staged = []
        for chain in chains:
            n = int(rng.integers(0, len(chain) + 1)) if rng.random() < 0.3 else len(chain)
            staged.append(list(range(page, page + n)))
            page += n
        steps.append(("chains", chains, staged))
        if t == 1:
            ks = _hashes(rng, 5)
            steps.append(("plain", np.asarray(ks, np.int32),
                          np.arange(page, page + 5, dtype=np.int32)[:, None],
                          np.full(5, OP_ACCESS, np.int32)))
            page += 5
        if t == 4:
            ks = [h for c in templates[:3] for h in c]
            steps.append(("plain", np.asarray(ks, np.int32), None,
                          np.full(len(ks), OP_LOOKUP, np.int32)))
    return steps


def _result(res) -> dict:
    return {f: np.asarray(getattr(res, f)).copy() for f in
            ("hit", "value", "evicted_valid", "evicted_val", "pos")}


def drive_client(client, steps, table_fn) -> dict:
    """Run ``steps`` through ``client`` (the JAX package's
    ``ShardedCacheClient`` or the port's); ``table_fn(client)`` gives its
    table as numpy.  Returns every result, shed mask, counter, pressure,
    orphan list and drain stream, and the final table."""
    rec = []
    for step in steps:
        kind = step[0]
        if kind == "route_fail":
            client.inject_route_failures(calls=step[1], frac=step[2], seed=step[3])
            continue
        if kind == "degrade":
            rec.append({"degrade": client.mark_degraded(step[1])})
            continue
        if kind == "reshard":
            orphans = client.reshard(step[1])
            rec.append({"reshard": orphans, "drain": [
                {k: (None if v is None else np.asarray(v).copy()) for k, v in b.items()}
                for b in client.last_drain_stream]})
            continue
        if kind == "chains":
            _, chains, staged = step
            keys, vals, ops, cids = chain_batch(chains, staged)
            res = client.access(keys, vals, ops=ops, chain_ids=cids)
            for c in chains:
                client.note_chain(c)
        else:
            _, keys, vals, ops = step
            res = client.access(keys, vals, ops=ops)
        rec.append({"res": _result(res), "shed": np.asarray(client.last_shed).copy(),
                    "counters": tuple(getattr(client, c) for c in COUNTERS),
                    "pressure": np.asarray(client.slab_pressure).copy(),
                    "route_shape": client.route_shape})
    tbl = table_fn(client)[: client.cfg.num_sets]
    return {"steps": rec, "table": tbl, "occupancy": client.occupancy,
            "degraded": sorted(client.degraded), "ndev": client.ndev}


def assert_records_equal(got, want, path="record"):
    """Deep equality of two records (numpy arrays compared exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_records_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_records_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and np.array_equal(g, w), (path, g, w)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# serving behind a D = 2 client
# ---------------------------------------------------------------------------

# name -> (engine kwargs, backend kwargs, fault plan); a plan is a list of
# (tick, kind, arg, frac, seed) events or ("seeded", seed, ticks, n_events).
# FaultPlan.seeded(seed, ticks=12, ndev=2, n_events=3) for seeds 9 and 31
# degrades, resizes and fails routes, each on a shard the mesh has then
SERVE_CASES = {
    "paged_inflight_split_handplan": (
        dict(kv_mode="paged", throttle_threshold=0.75),
        dict(cap=1.0, placement="split"),
        [(1, "degrade", 1, 0.5, 0), (3, "route_fail", 2, 0.5, 3), (8, "resize", 2, 0.5, 0)]),
    "contiguous_megastep_split_seeded": (
        dict(kv_mode="contiguous", decode_mode="megastep", throttle_threshold=0.75),
        dict(cap=2.0, placement="split"), ("seeded", 9, 12, 3)),
}
SLOW_SERVE_CASES = {
    "paged_megastep_full": (dict(kv_mode="paged", decode_mode="megastep"),
                            dict(cap="full"), None),
    "contiguous_inflight_load_degrade": (
        dict(kv_mode="contiguous"), dict(cap=1.0, placement="load"),
        [(1, "lose", 1, 0.5, 0), (6, "resize", 2, 0.5, 0)]),
    "paged_roundrobin_roundrobin_place": (
        dict(kv_mode="paged", decode_mode="roundrobin", throttle_threshold=0.5),
        dict(cap=2.0, placement="roundrobin"), ("seeded", 31, 12, 3)),
    "paged_split_admission": (dict(kv_mode="paged", admit_mode="split"),
                              dict(cap=1.0, placement="split"),
                              [(3, "route_fail", 1, 0.6, 9)]),
}
BACKEND_CFG = dict(num_sets=32, m=2, p=4, value_planes=1)
ENGINE = dict(slots=3, max_len=128)
N_PAGES = 48
MAX_NEW = 4


def prompts(cfg, n=10):
    """Shared 32- and 48-token templates (2-3 chunks of 16) with 5-13 token
    suffixes (same-tick duplicates and borrowers, chains that split), every
    third request a one-chunk prompt (a single home shard, which throttling
    may let ahead of a hot request)."""
    rng = np.random.default_rng(21)
    tmpl = [rng.integers(1, cfg.vocab_size, 32 + 16 * (i % 2)).astype(np.int32)
            for i in range(4)]
    return [rng.integers(1, cfg.vocab_size, 20).astype(np.int32) if i % 3 == 2 else
            np.concatenate([tmpl[i % 4], rng.integers(1, cfg.vocab_size, 5 + i % 9)
                            .astype(np.int32)]) for i in range(n)]


def fault_plan(event_cls, plan_cls, spec):
    """A ``FaultPlan`` (of either package) from a case's plan spec."""
    if spec is None:
        return None
    if spec[0] == "seeded":
        _, seed, ticks, n_events = spec
        return plan_cls.seeded(seed, ticks=ticks, ndev=2, n_events=n_events)
    return plan_cls([event_cls(t, k, a, frac=f, seed=s) for t, k, a, f, s in spec])


def summary(eng, table):
    """Everything a served run reports, tokens apart from the rest."""
    pool = eng.pool
    return {"tokens": {r.rid: [int(x) for x in r.out_tokens] for r in eng.finished},
            "rest": {"order": [r.rid for r in eng.finished],
                     "prefill": [(r.rid, r.prefill_skipped, r.prefill_computed)
                                 for r in eng.finished],
                     "ticks": eng.ticks, "fault_log": list(eng.fault_log),
                     "stats": eng.stats(), "cache": eng.prefix_cache.stats(),
                     "pool": (pool.refcount.tolist(), pool.free_pages, len(pool._reserved)),
                     "pending": len(eng._pending_inserts), "table": table[:32].tolist()}}


# ---------------------------------------------------------------------------
# resharding under eviction pressure (tests/test_reshard.py's workload)
# ---------------------------------------------------------------------------

RESHARD_CFG = dict(num_sets=64, m=2, p=2, value_planes=1)


def reshard_calls(seed: int, n: int = 180):
    """``tests/test_reshard.py``'s chain accesses: about 360 distinct
    chunks against 256 entry slots, every third chain a Zipf(1.5) pick.
    Yields (keys, vals, ops, chain_ids, chain) per access."""
    rng = np.random.default_rng(seed)
    pool = [[int(h) | 1 for h in rng.integers(1, 2**30, int(L))]
            for L in rng.integers(1, 6, 120)]
    page = 1
    for i in range(n):
        c = pool[i % len(pool)] if i % 3 else pool[int(rng.zipf(1.5)) % len(pool)]
        L = len(c)
        vals = np.zeros((2 * L, 1), np.int32)
        vals[L:, 0] = np.arange(page, page + L)
        page += L
        yield (np.array(c + c, np.int32), vals,
               np.array([OP_CHAIN_GET] * L + [OP_CHAIN_PUT] * L, np.int32),
               np.zeros(2 * L, np.int32), c)


def drive_reshard(client, seed: int, new_ndev: int, table_fn) -> dict:
    """``reshard_calls(seed)`` through ``client`` (either package's), then
    ``reshard(new_ndev)``: the occupancy before and after, the orphans, the
    drain stream, the rebuilt table (``table_fn(client)``, numpy) and
    whether every re-inserted chain is resident (a LOOKUP sweep)."""
    for keys, vals, ops, cids, chain in reshard_calls(seed):
        client.access(keys, vals, ops, cids)
        client.note_chain(chain)
    occ_before = client.occupancy
    orphans = client.reshard(new_ndev)
    rec = {"orphans": orphans, "occ_before": occ_before, "ndev": client.ndev,
           "drain": [{k: (None if v is None else np.asarray(v).copy()) for k, v in b.items()}
                     for b in client.last_drain_stream],
           "table": np.asarray(table_fn(client))[: client.cfg.num_sets]}
    rec["occ_after"] = client.occupancy
    rec["resident"] = all(bool(np.asarray(client.access(
        b["keys"], ops=np.full(b["keys"].size, OP_LOOKUP, np.int32)).hit).all())
        for b in client.last_drain_stream)
    return rec


def client_state(client) -> dict:
    """The host state of a ``ShardedCacheClient`` that every rank of a
    process mesh holds alike."""
    tf = client._transient_fail
    return {"registry": dict(client._chain_registry), "touch": client._touch,
            "degraded": sorted(client.degraded),
            "pressure": np.asarray(client.slab_pressure).copy(),
            "counters": tuple(getattr(client, c) for c in COUNTERS),
            "last_shed": None if client.last_shed is None else client.last_shed.copy(),
            "route_shape": client.route_shape, "ndev": client.ndev,
            "s_local": client._s_local,
            "transient": None if tf is None else (tf[0], tf[1], tf[2].bit_generator.state),
            "drain": [{k: (None if v is None else np.asarray(v).copy()) for k, v in b.items()}
                      for b in client.last_drain_stream]}
