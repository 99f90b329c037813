"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc, which builds the kernels at
first use) and skips without one.  On a machine with a card run

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CPU parity tests (test_torch_rows/engine/cache.py) hold the plain
versions against the JAX package; these hold the kernels against the
plain versions, bit for bit.  This file imports no JAX: the machine with
the card need not have it.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, init_table,
                              table_to_numpy)
from repro_torch.core.engine import sorted_group_ranks
from repro_torch.core.multistep import set_index_for
from repro_torch.kernels import msl_cache

# (m, p, key_planes, value_planes, policy, cost_planes): the JAX kernel
# tests' seven geometries plus a cost plane (as in test_torch_rows.py)
ROW_GEOMS = [(2, 4, 1, 2, "multistep", 0), (1, 4, 1, 1, "multistep", 0),
             (4, 2, 2, 2, "multistep", 0), (2, 8, 1, 0, "multistep", 0),
             (1, 8, 1, 2, "multistep", 0), (2, 4, 1, 2, "set_lru", 0),
             (8, 4, 2, 3, "multistep", 0), (2, 4, 1, 2, "multistep", 1)]
VARIANTS = ["access", "mixed_ops", "chain_live"]
EMPTY_KEY = -(2**31)


def random_rows_case(geom, seed, b):
    """(cfg kwargs, rows, qkeys, qvals, ops, chain_live, costs) as numpy:
    distinct keys per row, a quarter of the lanes empty, half the queries a
    key of their own row, small costs so that victim ties occur."""
    m, p, kp, v, policy, cost = geom
    a, c = m * p, kp + v + cost
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1000, 1000, (b, a, c)).astype(np.int32)
    keys = np.arange(a) * 100_003 + rng.integers(1, 100_000, (b, a))
    rows[:, :, 0] = np.where(rng.random((b, a)) < 0.25, EMPTY_KEY, keys)
    if cost:
        rows[:, :, -1] = rng.integers(0, 3, (b, a))
    own = rows[np.arange(b), rng.integers(0, a, b), :kp]
    fresh = np.concatenate([rng.integers(200_000, 300_000, (b, 1)),
                            rng.integers(0, 50, (b, kp - 1))], 1)
    use_own = (rng.random(b) < 0.5) & (own[:, 0] != EMPTY_KEY)
    qk = np.where(use_own[:, None], own, fresh).astype(np.int32)
    qv = rng.integers(-500, 500, (b, v)).astype(np.int32)
    kw = dict(num_sets=64, m=m, p=p, key_planes=kp, value_planes=v,
              cost_planes=cost, policy=policy)
    return (kw, rows, qk, qv, rng.integers(0, 6, b).astype(np.int32),
            rng.integers(0, 2, b).astype(np.int32),
            rng.integers(0, 5, b).astype(np.int32))


def variant_operands(variant, ops, live, costs, cost_planes):
    """(ops, chain_live, costs) a variant passes (None where it passes none)."""
    return {"access": (None, None, costs if cost_planes else None),
            "mixed_ops": (ops, None, costs),
            "chain_live": (ops, live, costs)}[variant]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_outputs_equal(want, got):
    for name, w, g in zip(["rows", "hit", "pos", "value", "ev"], want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{name} mismatch")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geom", ROW_GEOMS, ids=lambda g: "-".join(map(str, g)))
def test_access_kernel_matches_plain(cuda, geom, variant):
    kw, rows, qk, qv, ops, live, costs = random_rows_case(geom, seed=1, b=1000)
    cfg = MSLRUConfig(**kw)
    extra = [None if x is None else torch.from_numpy(x).to(cuda)
             for x in variant_operands(variant, ops, live, costs, cfg.cost_planes)]
    args = [torch.from_numpy(x).to(cuda) for x in (rows, qk, qv)] + extra
    before = msl_cache.LAUNCHES["msl_access"]
    got = msl_cache.msl_access_kernel_call(*args, cfg=cfg)
    assert msl_cache.LAUNCHES["msl_access"] == before + 1
    _assert_outputs_equal(msl_cache.msl_access_plain(*args, cfg=cfg), got)


def _sorted_chain_case(geom, device, seed, b=600):
    """(cfg, one-pass kernel operands) for a batch sorted into long chains:
    random rows as in the row tests, keys from a small pool so that chain
    members hit what earlier members inserted, all six opcodes, a random
    served mask and chain execute mask."""
    kw, rows, _, _, _, live, costs = random_rows_case(geom, seed, b)
    cfg = MSLRUConfig(**{**kw, "num_sets": 4})
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 40, (b, cfg.key_planes)).astype(np.int32)
    keys[:, 1:] = rng.integers(0, 2, (b, cfg.key_planes - 1))
    vals = rng.integers(-99, 99, (b, cfg.value_planes)).astype(np.int32)
    ops = rng.integers(0, 6, b).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    sids = set_index_for(cfg, t(keys))
    order = torch.sort(sids, stable=True).indices
    ssid = sids[order]
    _, rank = sorted_group_ranks(ssid)
    served = (t(rng.random(b) < 0.9) & (rank < 100)).to(torch.int32)

    def srt(x):
        return t(x)[order].contiguous()

    return cfg, (t(rows), srt(keys), srt(vals), srt(ops), ssid, rank, served,
                 srt(live), srt(costs))


@pytest.mark.parametrize("geom", ROW_GEOMS, ids=lambda g: "-".join(map(str, g)))
def test_onepass_kernel_matches_plain(cuda, geom):
    cfg, case = _sorted_chain_case(geom, cuda, seed=2)
    rows, qk, qv, ops, sids, rank, served, live, costs = case
    for o, lv, c in ((None, None, None), (ops, None, costs), (ops, live, costs)):
        args = (rows, qk, qv, o, sids, rank, served, lv, c)
        before = msl_cache.LAUNCHES["msl_onepass"]
        got = msl_cache.msl_onepass_kernel_call(*args, cfg=cfg)
        assert msl_cache.LAUNCHES["msl_onepass"] == before + 1
        _assert_outputs_equal(msl_cache.chain_resolve_plain(*args, cfg=cfg), got)


@pytest.mark.parametrize("kw", [dict(num_sets=64, m=2, p=4, value_planes=2),
                                dict(num_sets=32, m=2, p=4, value_planes=1,
                                     cost_planes=1)])
def test_cache_engines_agree_on_the_card(cuda, kw):
    """One-pass == rounds == sequential through the kernels, and the run
    really launched both kernels."""
    from repro_torch.data.ycsb import zipfian

    cfg = MSLRUConfig(**kw)
    keys = zipfian(8 * cfg.capacity, 4096, seed=5)
    vals = (keys[:, None] * np.arange(1, cfg.value_planes + 1)).astype(np.int32)
    costs = (keys % 7).astype(np.int32) if cfg.cost_planes else None
    caches = {e: MultiStepLRUCache(cfg, engine=e, device=cuda)
              for e in ("onepass", "rounds")}
    seq = MultiStepLRUCache(cfg, device=cuda)
    before = dict(msl_cache.LAUNCHES)
    for i in range(0, len(keys), 1024):
        q = slice(i, i + 1024)
        c = None if costs is None else costs[q]
        want = seq.access_seq(keys[q], vals[q], costs=c)
        for e, cache in caches.items():
            got = cache.access(keys[q], vals[q], costs=c)
            for f in ("hit", "pos", "evicted_key", "evicted_valid"):
                np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                              getattr(want, f).cpu().numpy(),
                                              err_msg=f"{e}: {f}")
    for cache in caches.values():
        np.testing.assert_array_equal(table_to_numpy(cache.table),
                                      table_to_numpy(seq.table))
    assert msl_cache.LAUNCHES["msl_onepass"] > before["msl_onepass"]
    assert msl_cache.LAUNCHES["msl_access"] > before["msl_access"]


@pytest.mark.parametrize("engine", ["rounds", "onepass"])
def test_stream_runner_runs_the_kernels_on_the_card(cuda, engine):
    """The engine functions pick the kernel by the table's device: a CUDA
    table launches the engine's kernel and ends bit-equal to a CPU table
    through the plain versions."""
    from repro_torch.core.engine import make_chunked_stream_runner
    from repro_torch.data.ycsb import zipfian

    cfg = MSLRUConfig(num_sets=64, m=2, p=4, value_planes=1)
    keys = torch.from_numpy(zipfian(8 * cfg.capacity, 2048, seed=7)[:, None]
                            .astype(np.int32))
    vals = keys * 3
    run = make_chunked_stream_runner(cfg, 512, engine=engine)
    want_table, want_hits = run(init_table(cfg, "cpu"), keys, vals)
    name = "msl_access" if engine == "rounds" else "msl_onepass"
    before = msl_cache.LAUNCHES[name]
    table, hits = run(init_table(cfg, cuda), keys.to(cuda), vals.to(cuda))
    assert msl_cache.LAUNCHES[name] > before
    assert int(hits) == int(want_hits)
    np.testing.assert_array_equal(table_to_numpy(table), table_to_numpy(want_table))


def test_kernel_refuses_wide_sets(cuda):
    cfg = MSLRUConfig(num_sets=4, m=8, p=8, value_planes=0)
    rows = init_table(cfg, cuda)[:2].contiguous()
    keys = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    vals = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="A = 64"):
        msl_cache.msl_access_kernel_call(rows, keys, vals, cfg=cfg)
