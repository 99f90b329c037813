"""The port's Python oracle and baselines (``repro_torch.core.policies``)
against the JAX package's (``repro.core.policies``), and the port's cache
engines against the port's oracle.

* ``fmix32_py`` / ``fmix64_py`` equal JAX's on random ints and the canonical
  MurmurHash3 vectors; the opcode literals equal ``core.multistep``'s.
* Every baseline (``ExactLRU`` with deletes, ``GClock``, ``ARC`` with its
  t1/t2 split and target ``p``, ``FIFO``, the Mattson ``ReuseDistanceLRU``)
  gives JAX's hit sequence and end state on seeded Zipf traces.
* ``MultiStepLRUOracle.apply_batch`` gives JAX's records and ``dump_keys``
  on mixed ops with chains and costs, in every geometry.
* The port's sequential, rounds and one-pass engines (plain versions, on the
  CPU) give the port oracle's records and table keys, bit for bit, on mixed
  ops, chains and costs, with Hypothesis over seeds and geometries
  (``value_planes=0`` among them: value arrays are shaped (n, V), never
  ``reshape(-1, V)``).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import policies as jax_policies
from repro.data.ycsb import zipfian
from repro_torch.core import MSLRUConfig, MultiStepLRUCache
from repro_torch.core import multistep
from repro_torch.core import policies

import torch_oracle_cases as oc

MASK32 = 0xFFFFFFFF


def test_fmix_matches_jax_and_reference_vectors():
    rng = np.random.default_rng(0)
    xs = [0, 1, MASK32, 2**31, 2**63, 2**64 - 1] + rng.integers(0, 2**63, 2000).tolist()
    for x in xs:
        assert policies.fmix32_py(x) == jax_policies.fmix32_py(x)
        assert policies.fmix64_py(x) == jax_policies.fmix64_py(x)
    assert policies.fmix32_py(1) == 0x514E28B7
    assert policies.fmix32_py(MASK32) == 0x81F16F39
    assert policies.fmix64_py(1) == 0xB456BCFC34C2CB2C


def test_opcodes_equal_the_engines_and_the_prefix_cache_hash_is_the_oracle_s():
    names = ("OP_ACCESS", "OP_GET", "OP_DELETE", "OP_LOOKUP", "OP_CHAIN_GET", "OP_CHAIN_PUT")
    for name in names:
        assert getattr(policies, name) == getattr(multistep, name) == getattr(jax_policies, name)
    from repro_torch.serving import prefix_cache
    assert prefix_cache.fmix32_py is policies.fmix32_py
    assert "fmix32_py" in prefix_cache.__all__


def _trace(seed, n=20_000, n_keys=3_000):
    return zipfian(n_keys, n, alpha=0.99, seed=seed).tolist()


@pytest.mark.parametrize("cap", [64, 500, 2048])
@pytest.mark.parametrize("name", ["ExactLRU", "GClock", "ARC", "FIFO"])
def test_baseline_matches_jax(name, cap):
    trace = _trace(cap)
    mine, ref = getattr(policies, name)(cap), getattr(jax_policies, name)(cap)
    got, want = [], []
    for k in trace:
        got.append((mine.access(k), getattr(mine, "last_hit_list", None)))
        want.append((ref.access(k), getattr(ref, "last_hit_list", None)))
    assert got == want
    assert 0 < sum(h for h, _ in got) < len(trace)
    if name == "ARC":
        assert mine.p == ref.p
        for lst in ("t1", "t2", "b1", "b2"):
            assert list(getattr(mine, lst)) == list(getattr(ref, lst))
        assert {h for h, _ in got if h} == {True}
        assert {w for h, w in got if h} == {"t1", "t2"}
    elif name == "GClock":
        assert (mine.hand, mine.keys, mine.count.tolist()) == (ref.hand, ref.keys,
                                                               ref.count.tolist())
    else:
        assert list(mine.od) == list(ref.od)
    if name == "ExactLRU":
        rng = np.random.default_rng(cap)
        for k in rng.choice(trace, 200).tolist():
            assert mine.delete(k) == ref.delete(k)
        assert list(mine.od) == list(ref.od)


def test_reuse_distance_matches_jax_at_every_size():
    trace = _trace(7, n=30_000)
    mine, ref = policies.ReuseDistanceLRU(len(trace)), jax_policies.ReuseDistanceLRU(len(trace))
    mine.feed(trace)
    ref.feed(np.asarray(trace))
    assert (mine.dist_hist, mine.cold, mine.t) == (ref.dist_hist, ref.cold, ref.t)
    for size in (1, 16, 100, 512, 1000, 2999, 10_000):
        assert mine.hit_ratio(size) == ref.hit_ratio(size)
    # against a direct simulation: ``hits_for(c)`` counts reuse distances
    # d <= c, where d is the number of other distinct keys since the last
    # access, and an LRU of capacity c hits iff d < c.  So the analyzer (the
    # JAX package's, copied as it is) gives exact LRU at capacity c + 1.
    for cap in (64, 512):
        lru = policies.ExactLRU(cap + 1)
        assert mine.hits_for(cap) == sum(lru.access(k) for k in trace)
        lru = policies.ExactLRU(cap)
        assert mine.hits_for(cap - 1) == sum(lru.access(k) for k in trace)


ORACLE_CFGS = [
    dict(num_sets=16, m=2, p=4, value_planes=2),
    dict(num_sets=8, m=1, p=4, value_planes=0),
    dict(num_sets=16, m=2, p=2, key_planes=2, value_planes=1, cost_planes=1),
    dict(num_sets=16, m=4, p=2, value_planes=1, policy="set_lru", cost_planes=1),
    dict(num_sets=8, m=8, p=4, value_planes=2, cost_planes=1),
    dict(num_sets=16, m=2, p=8, key_planes=2, value_planes=2, policy="set_lru"),
]


def _jax_oracle(cfg):
    return jax_policies.MultiStepLRUOracle(cfg.num_sets, cfg.m, cfg.p, policy=cfg.policy,
                                           key_planes=cfg.key_planes,
                                           cost_planes=cfg.cost_planes)


@pytest.mark.parametrize("kw", ORACLE_CFGS, ids=str)
def test_oracle_matches_jax(kw):
    cfg = MSLRUConfig(**kw)
    rng = np.random.default_rng(len(str(kw)))
    mine, ref = oc.oracle_for(cfg), _jax_oracle(cfg)
    evictions = 0
    for _ in range(6):
        batch = oc.mixed_batch(rng, cfg, 160, 3 * cfg.capacity)
        got = oc.apply_oracle(mine, cfg, batch)
        assert got == oc.apply_oracle(ref, cfg, batch)
        evictions += sum(r["evicted"] is not None for r in got)
        assert mine.sets == ref.sets
        if cfg.key_planes == 1:
            np.testing.assert_array_equal(mine.dump_keys(), ref.dump_keys())
    assert evictions
    # single-op entry points too
    for k in rng.integers(1, 3 * cfg.capacity, 200).tolist():
        key = (k % 4, k) if cfg.key_planes == 2 else k
        assert mine.access(key, (k,) * cfg.value_planes, k % 3) == \
            ref.access(key, (k,) * cfg.value_planes, k % 3)
        assert mine.lookup(key) == ref.lookup(key)
    assert mine.sets == ref.sets


def _run_engines_against_oracle(cfg, seed, n_batches=3, b=96):
    """Every port engine (CPU) against the port's oracle, batch by batch:
    records and table keys bit-equal."""
    rng = np.random.default_rng(seed)
    oracle = oc.oracle_for(cfg)
    caches = {e: MultiStepLRUCache(cfg, engine=e, device="cpu") for e in ("onepass", "rounds")}
    seq = MultiStepLRUCache(cfg, device="cpu")
    for i in range(n_batches):
        batch = oc.mixed_batch(rng, cfg, b, 3 * cfg.capacity)
        recs = oc.apply_oracle(oracle, cfg, batch)
        args = (batch["keys"], batch["vals"], batch["ops"], batch["chain_ids"],
                batch["costs"] if cfg.cost_planes else None)
        runs = {name: (c.access, c) for name, c in caches.items()}
        runs["sequential"] = (seq.access_seq, seq)
        for name, (fn, cache) in runs.items():
            res = fn(*args)
            res = type(res)(*(x.numpy() for x in res))
            assert not oc.mismatches(cfg, recs, res), (name, i, oc.mismatches(cfg, recs, res))
            assert not oc.table_mismatch(cfg, oracle, cache.table.numpy()), (name, i)


@pytest.mark.parametrize("kw", ORACLE_CFGS, ids=str)
def test_engines_match_the_oracle(kw):
    _run_engines_against_oracle(MSLRUConfig(**kw), seed=len(str(kw)))


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), geometry=st.sampled_from(ORACLE_CFGS),
       value_planes=st.sampled_from([0, 1, 2]), cost_planes=st.sampled_from([0, 1]))
def test_engines_match_the_oracle_hypothesis(seed, geometry, value_planes, cost_planes):
    cfg = MSLRUConfig(**dict(geometry, value_planes=value_planes, cost_planes=cost_planes))
    _run_engines_against_oracle(cfg, seed, n_batches=2, b=64)
