"""The paper's qualitative claims (tests/test_paper_claims.py, c1-c6) on the
port's one-pass engine, with its plain version on the CPU, with that test's
assertions and margins.

The plain chain loop runs once per member of a batch's longest same-set
chain, about 80 µs per Zipf query here, so the fast lane runs the JAX
test's trace at a quarter of its size with the same ratios (keys : capacity
12.2, queries : keys 6; 12.5k keys, 75k queries, capacity 1024, about 50 s
serially); the JAX test's own size (50k keys, 300k queries, capacity 4096,
about 120 s) is ``slow``.  The one-pass engine's hits and positions equal
the JAX sequential engine's on a prefix of the trace.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import init_table as jax_init_table
from repro.core import make_sequential_engine
from repro.data.ycsb import zipfian
from repro_torch.core import MSLRUConfig, MultiStepLRUCache, init_table, table_to_numpy
from repro_torch.core.policies import ARC, ReuseDistanceLRU

SCALES = {"quarter": (12_500, 75_000, 1024), "full": (50_000, 300_000, 4096)}
SCALE_PARAMS = ["quarter", pytest.param("full", marks=pytest.mark.slow)]
BATCH = 512
PREFIX = 6_000          # queries held against the JAX sequential engine
_RESULTS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(scale):
    n_keys, n_q, _ = SCALES[scale]
    return zipfian(n_keys, n_q, alpha=0.99, seed=42)


def _cfg(cap, m, policy="multistep"):
    return MSLRUConfig(num_sets=cap // (m * 4), m=m, p=4, value_planes=0, policy=policy)


def _port_hits(trace, cfg, table=None):
    """The one-pass engine (plain, CPU) over ``trace`` in BATCH batches."""
    cache = MultiStepLRUCache(cfg, device="cpu")
    if table is not None:
        cache.load_table(table)
    hits, pos = [], []
    for s in range(0, len(trace), BATCH):
        res = cache.access(torch.from_numpy(trace[s:s + BATCH]))
        hits.append(res.hit.numpy())
        pos.append(res.pos.numpy())
    return np.concatenate(hits), np.concatenate(pos)


def _results(scale):
    if scale not in _RESULTS:
        trace = _trace(scale)
        cap = SCALES[scale][2]
        res = {}
        for m in (1, 2, 4, 8):
            hits, pos = _port_hits(trace, _cfg(cap, m))
            res[f"m{m}"] = hits.mean()
            res[f"m{m}_hits"], res[f"m{m}_pos"] = hits, pos
        hits, pos = _port_hits(trace, _cfg(cap, 2, "set_lru"))
        res["set_lru"], res["set_lru_hits"], res["set_lru_pos"] = hits.mean(), hits, pos
        rd = ReuseDistanceLRU(len(trace))
        rd.feed(trace.tolist())
        res["lru"] = rd.hit_ratio(cap)
        arc = ARC(cap)
        res["arc"] = np.mean([arc.access(k) for k in trace.tolist()])
        _RESULTS[scale] = res
    return _RESULTS[scale]


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_onepass_equals_the_jax_sequential_engine_on_a_prefix(scale):
    trace, cap = _trace(scale), SCALES[scale][2]
    res = _results(scale)
    for name, m, policy in (("m2", 2, "multistep"), ("m4", 4, "multistep"),
                            ("set_lru", 2, "set_lru")):
        jcfg = JaxConfig(num_sets=cap // (m * 4), m=m, p=4, value_planes=0, policy=policy)
        _, out = make_sequential_engine(jcfg)(
            jax_init_table(jcfg), jnp.asarray(trace[:PREFIX, None], jnp.int32),
            jnp.zeros((PREFIX, 0), jnp.int32))
        np.testing.assert_array_equal(res[f"{name}_hits"][:PREFIX], np.asarray(out.hit))
        np.testing.assert_array_equal(res[f"{name}_pos"][:PREFIX], np.asarray(out.pos))


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c1_multistep_beats_exact_lru(scale):
    results = _results(scale)
    assert results["m2"] > results["lru"]


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c2_multistep_beats_invector(scale):
    results = _results(scale)
    assert results["m2"] > results["m1"]


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c3_invector_below_set_lru_below_lru(scale):
    results = _results(scale)
    assert results["m1"] <= results["set_lru"] + 0.002
    assert results["set_lru"] <= results["lru"] + 0.002


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c4_hit_ratio_rises_with_m_toward_arc(scale):
    results = _results(scale)
    assert results["m1"] < results["m2"] <= results["m4"] + 5e-3
    assert results["m8"] >= results["m4"] - 0.01
    assert max(results["m4"], results["m8"]) >= 0.85 * results["arc"]


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c5_vector0_dominates(scale):
    pos = _results(scale)["m4_pos"]
    vec = pos[pos >= 0] // 4
    counts = np.bincount(vec, minlength=4)
    assert counts[0] == counts.max()


@pytest.mark.parametrize("scale", SCALE_PARAMS)
def test_c6_warmup_penalty(scale):
    trace, cap = _trace(scale), SCALES[scale][2]
    n = len(trace) // 3                     # the JAX test's 100k of 300k
    rng = np.random.default_rng(0)
    garbage = rng.integers(2**29, 2**30, (cap // 8, 8)).astype(np.int32)
    h = {}
    for policy in ("multistep", "set_lru"):
        cfg = _cfg(cap, 2, policy)
        tbl = table_to_numpy(init_table(cfg, "cpu"))
        tbl[:, :, 0] = garbage
        h[policy], _ = _port_hits(trace[:n], cfg, table=tbl)
    # early-window hit ratio: multistep ramps no faster than per-set LRU
    w = len(trace) // 15                    # the JAX test's 20k of 300k
    assert h["multistep"][:w].mean() <= h["set_lru"][:w].mean() + 0.005
