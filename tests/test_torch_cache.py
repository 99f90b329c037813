"""The slice as a whole: the port's ``MultiStepLRUCache`` (one-pass and
rounds engines, and the sequential ``access_seq``) against the JAX package's
cache on the duplicate-heavy Zipf stream of the one-pass engine tests, in
256-query batches: hits, positions, values and final tables bit-equal,
including a run that starts from a table the JAX package warmed."""

import numpy as np
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import MultiStepLRUCache as JaxCache
from repro.data.ycsb import make_workload as jax_make_workload
from repro.data.ycsb import zipfian as jax_zipfian
from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, table_from_numpy,
                              table_to_numpy)
from repro_torch.data.ycsb import make_workload, zipfian, zipfian_tensor

BATCH = 256
FIELDS = ("hit", "pos", "value", "evicted_key", "evicted_val", "evicted_valid")

CACHE_CFGS = [
    dict(num_sets=16, m=2, p=4, value_planes=2),
    dict(num_sets=16, m=2, p=4, value_planes=0, policy="set_lru"),
    dict(num_sets=16, m=2, p=4, value_planes=1, cost_planes=1),
]


def _stream(kw, n=2048, seed=7):
    """Zipf 0.99 over a key space 8x the set count: per-set multiplicity
    in a 256-query batch is routinely 3 and more."""
    keys = zipfian(8 * kw["num_sets"], n, alpha=0.99, seed=seed).astype(np.int32)
    v = kw["value_planes"]
    vals = (keys[:, None] * (3 + 2 * np.arange(v, dtype=np.int32))).astype(np.int32)
    costs = (keys % 5).astype(np.int32) if kw.get("cost_planes") else None
    return keys, vals, costs


def _batches(n):
    return [slice(i, min(i + BATCH, n)) for i in range(0, n, BATCH)]


def _run(cache, keys, vals, costs, seq=False):
    call = cache.access_seq if seq else cache.access
    outs = [call(keys[q], vals=vals[q], costs=None if costs is None else costs[q])
            for q in _batches(len(keys))]
    return {f: np.concatenate([_np(getattr(o, f)) for o in outs]) for f in FIELDS}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(want, got, what):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")


@pytest.mark.parametrize("ci", range(len(CACHE_CFGS)))
def test_cache_stream_matches_jax(ci):
    kw = CACHE_CFGS[ci]
    keys, vals, costs = _stream(kw)
    jseq = JaxCache(JaxConfig(**kw))
    want_seq = _run(jseq, keys, vals, costs, seq=True)
    for engine in ("onepass", "rounds"):
        jcache = JaxCache(JaxConfig(**kw), engine=engine)
        want = _run(jcache, keys, vals, costs)
        cache = MultiStepLRUCache(MSLRUConfig(**kw), engine=engine, device="cpu")
        got = _run(cache, keys, vals, costs)
        _assert_equal(want, got, engine)
        np.testing.assert_array_equal(table_to_numpy(cache.table),
                                      np.asarray(jseq.table))
        for f in ("hit", "pos"):
            np.testing.assert_array_equal(got[f], want_seq[f], err_msg=f)
    cache = MultiStepLRUCache(MSLRUConfig(**kw), device="cpu")
    _assert_equal(want_seq, _run(cache, keys, vals, costs, seq=True), "seq")
    np.testing.assert_array_equal(table_to_numpy(cache.table), np.asarray(jseq.table))
    assert cache.occupancy == pytest.approx(jseq.occupancy)


def test_cache_continues_from_jax_warmed_table():
    kw = dict(num_sets=16, m=2, p=4, value_planes=2)
    keys, vals, _ = _stream(kw, seed=11)
    warm, rest = slice(0, 1024), slice(1024, None)
    jcache = JaxCache(JaxConfig(**kw))
    _run(jcache, keys[warm], vals[warm], None)
    cache = MultiStepLRUCache(MSLRUConfig(**kw), device="cpu")
    cache.load_table(np.asarray(jcache.table))
    assert cache.occupancy > 0.5
    want = _run(jcache, keys[rest], vals[rest], None)
    _assert_equal(want, _run(cache, keys[rest], vals[rest], None), "warmed")
    np.testing.assert_array_equal(table_to_numpy(cache.table), np.asarray(jcache.table))
    # the round trip through numpy is lossless
    t = table_from_numpy(np.asarray(jcache.table), "cpu")
    np.testing.assert_array_equal(table_to_numpy(t), np.asarray(jcache.table))


def test_cache_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStepLRUCache(MSLRUConfig(num_sets=4), device="cuda")


@pytest.mark.parametrize("alpha,scrambled", [(0.99, True), (0.7, False)])
def test_zipfian_matches_jax_package(alpha, scrambled):
    want = jax_zipfian(5000, 20000, alpha=alpha, scrambled=scrambled, seed=4)
    np.testing.assert_array_equal(zipfian(5000, 20000, alpha, scrambled, seed=4), want)
    got = zipfian_tensor(5000, 20000, alpha, scrambled, seed=4, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["zipfian", "latest", "scan"])
def test_workloads_match_jax_package(name):
    np.testing.assert_array_equal(make_workload(name, 3000, 10000, 0.9, seed=2),
                                  jax_make_workload(name, 3000, 10000, 0.9, seed=2))


@pytest.mark.slow
def test_onepass_100k_zipfian_matches_jax_sequential():
    """Acceptance: the port's one-pass cache on a 100k-query Zipf stream
    (α=0.99) against the JAX package's sequential engine."""
    kw = dict(num_sets=256, m=2, p=4, value_planes=0)
    keys = zipfian(20_000, 100_000, alpha=0.99, seed=11).astype(np.int32)
    vals = np.zeros((len(keys), 0), np.int32)
    jseq = JaxCache(JaxConfig(**kw))
    out = jseq.access_seq(keys, vals=vals)
    cache = MultiStepLRUCache(MSLRUConfig(**kw), device="cpu")
    hits = [cache.access(keys[i:i + 4096], vals[i:i + 4096]).hit.numpy()
            for i in range(0, len(keys), 4096)]
    np.testing.assert_array_equal(np.concatenate(hits), np.asarray(out.hit))
    np.testing.assert_array_equal(table_to_numpy(cache.table), np.asarray(jseq.table))
