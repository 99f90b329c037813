"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc, which builds the kernels at
first use) and skips without one.  On a machine with a card run

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CPU parity tests (test_torch_rows/engine/cache/models/serving.py) hold
the plain versions against the JAX package; these hold the kernels against
the plain versions: the msl_cache kernels bit for bit (the one-pass kernel
also on test_torch_runs.py's batches of long repeated runs), the
paged-attention kernel within the JAX package's own gate for its Pallas
kernel, on rows split over thread block clusters.  This file imports no
JAX: the machine with the card need not have it.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, init_table,
                              pad_dummy_row, table_to_numpy)
from repro_torch.core.engine import sorted_group_ranks
from repro_torch.core.multistep import set_index_for
from repro_torch.kernels import msl_cache, paged_attn
from repro_torch.kernels.ops import onepass_prologue
from torch_run_cases import run_cases

RUN_CASES = run_cases()

# (m, p, key_planes, value_planes, policy, cost_planes): the JAX kernel
# tests' seven geometries plus a cost plane, then the access kernel's
# delicate lane groups: A = 12, A = 15 (P = 3), A = 2, A = 1, and A = 32
# with C = 8 (as in test_torch_rows.py)
ROW_GEOMS = [(2, 4, 1, 2, "multistep", 0), (1, 4, 1, 1, "multistep", 0),
             (4, 2, 2, 2, "multistep", 0), (2, 8, 1, 0, "multistep", 0),
             (1, 8, 1, 2, "multistep", 0), (2, 4, 1, 2, "set_lru", 0),
             (8, 4, 2, 3, "multistep", 0), (2, 4, 1, 2, "multistep", 1),
             (3, 4, 1, 2, "multistep", 0), (5, 3, 1, 2, "multistep", 0),
             (1, 2, 1, 1, "multistep", 0), (1, 1, 1, 1, "multistep", 0),
             (8, 4, 2, 5, "multistep", 1)]
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


@pytest.mark.parametrize("b", [1, 3, 1001])
@pytest.mark.parametrize("geom", ROW_GEOMS[:1] + ROW_GEOMS[-5:],
                         ids=lambda g: "-".join(map(str, g)))
def test_access_kernel_ragged_batches(cuda, geom, b):
    """Batches that end in a partial warp or a lone row (a warp holds
    32 / W rows), each operand a view one row into a larger batch, so that
    a warp's rows start at no particular alignment."""
    kw, rows, qk, qv, ops, live, costs = random_rows_case(geom, seed=3, b=b + 1)
    cfg = MSLRUConfig(**kw)
    args = [torch.from_numpy(x).to(cuda)[1:] for x in (rows, qk, qv, ops, live)]
    args.append(torch.from_numpy(costs).to(cuda)[1:] if cfg.cost_planes else None)
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


@pytest.mark.parametrize("served_holes", [False, True], ids=["served", "holes"])
@pytest.mark.parametrize("case", RUN_CASES, ids=[c.name for c in RUN_CASES])
def test_onepass_kernel_resolves_runs(cuda, case, served_holes):
    """The one-pass kernel against its plain version on the batches of long
    repeated runs that test_torch_runs.py holds against the JAX engine
    (the kernel collapses a run once its row stops changing); ``holes``
    also clears about one served bit in 30, inside chains and runs."""
    cfg = MSLRUConfig(**case.kw)

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    keys = t(case.keys)
    x = onepass_prologue(pad_dummy_row(t(case.table)), set_index_for(cfg, keys),
                         t(case.valid), keys, t(case.vals), case.max_rounds,
                         t(case.ops), t(case.chain_live), t(case.costs))
    args = list(x.kernel_args())
    if served_holes:
        keep = np.random.default_rng(7).random(len(case.keys)) >= 1 / 30
        args[6] = (args[6] * t(keep.astype(np.int32))).contiguous()
    before = msl_cache.LAUNCHES["msl_onepass"]
    got = msl_cache.msl_onepass_kernel_call(*args, cfg=cfg)
    assert msl_cache.LAUNCHES["msl_onepass"] == before + 1
    _assert_outputs_equal(msl_cache.chain_resolve_plain(*args, cfg=cfg), got)


def _seq_case(geom, device, seed, n):
    """(cfg, table, sids, qkeys, qvals, ops, chain_live, costs) for the
    sequential kernel: random rows as in the row tests for a table of 8
    sets, a stream of ``n`` keys from a small pool (hits, evictions, runs on
    one set and moves between sets), all six opcodes, chain mask, costs."""
    kw, rows, _, _, ops, live, costs = random_rows_case(geom, seed, max(n, 8))
    cfg = MSLRUConfig(**{**kw, "num_sets": 8})
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 120, (n, cfg.key_planes)).astype(np.int32)
    keys[:, 1:] = rng.integers(0, 2, (n, cfg.key_planes - 1))
    vals = rng.integers(-99, 99, (n, cfg.value_planes)).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    qk = t(keys)
    return (cfg, t(rows[:8]), set_index_for(cfg, qk), qk, t(vals), t(ops[:n]),
            t(live[:n]), t(costs[:n]))


# the sequential kernel's schedules: one warp over the whole stream in order,
# and the wrapper's own number of queues (``seq_owners``)
OWNERS = [1, None]


def _seq_equal(cfg, args, extra, owners=None):
    """The sequential kernel (``owners`` queues, None: the wrapper's
    choice) on a copy of the table against the plain version on a CPU copy
    of the same inputs: table and every output bit-equal, one launch."""
    table, rest = args[0], args[1:]
    before = msl_cache.LAUNCHES["msl_seq"]
    got = msl_cache.msl_seq_kernel_call(table.clone(), *rest, *extra, cfg=cfg, owners=owners)
    assert msl_cache.LAUNCHES["msl_seq"] == before + 1
    cpu = [None if x is None else x.cpu() for x in (table.clone(), *rest, *extra)]
    want = msl_cache.msl_seq_plain(*cpu, cfg=cfg)
    for name, w, g in zip(("table", "hit", "pos", "value", "evicted"), want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=f"{name} mismatch")


@pytest.mark.parametrize("owners", OWNERS, ids=["G1", "G"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geom", ROW_GEOMS, ids=lambda g: "-".join(map(str, g)))
def test_seq_kernel_matches_plain(cuda, geom, variant, owners):
    """A 2000-query stream on 8 sets (at G = 1, 62 full windows and a
    partial one on one warp; at the default G, a queue per set), against
    ``msl_seq_plain``."""
    cfg, table, sids, qk, qv, ops, live, costs = _seq_case(geom, cuda, seed=4, n=2000)
    _seq_equal(cfg, (table, sids, qk, qv),
               variant_operands(variant, ops, live, costs, cfg.cost_planes), owners)


@pytest.mark.parametrize("owners", OWNERS, ids=["G1", "G"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64])
def test_seq_kernel_stream_ends(cuda, n, owners):
    """Streams that end inside, at and just past a window of 32 queries."""
    cfg, table, sids, qk, qv, ops, live, costs = _seq_case(ROW_GEOMS[-1], cuda, seed=n, n=n)
    _seq_equal(cfg, (table, sids, qk, qv), (ops, live, costs), owners)


def _skewed_case(device, n, hot_share, seed):
    """(cfg, table, sids, qkeys, qvals) on 512 sets of m = 2, p = 4 from a
    cold table: ``hot_share`` of the ``n`` queries draw from 24 keys of one
    set (more than its 8 ways: hits, promotions and evictions on one long
    chain), the rest from a wide pool over every set."""
    cfg = MSLRUConfig(num_sets=512, m=2, p=4, value_planes=1)
    rng = np.random.default_rng(seed)
    pool = torch.arange(1, 200_000, dtype=torch.int32)[:, None]
    pool_sets = set_index_for(cfg, pool)
    hot = pool[pool_sets == pool_sets[0]][:24, 0].numpy()
    keys = rng.integers(1, 200_000, n).astype(np.int32)
    keys = np.where(rng.random(n) < hot_share, rng.choice(hot, n), keys)[:, None]
    qk = torch.from_numpy(keys).to(device)
    qv = (qk * 3).contiguous()
    return cfg, init_table(cfg, device), set_index_for(cfg, qk), qk, qv


@pytest.mark.parametrize("owners", OWNERS, ids=["G1", "G"])
def test_seq_kernel_skewed_stream(cuda, owners):
    """One hot set amid many cold ones (half of 6000 queries on one set of
    512): its queue is the longest by far, the other warps finish early."""
    cfg, table, sids, qk, qv = _skewed_case(cuda, 6000, 0.5, seed=3)
    hot = int(torch.bincount(sids.long()).max())
    assert hot > 2500
    _seq_equal(cfg, (table, sids, qk, qv), (), owners)


@pytest.mark.parametrize("n", [1, 40])
def test_seq_kernel_more_owners_than_queries(cuda, n):
    """More queues than queries (and than sets touched): most warps find an
    empty queue and exit."""
    cfg, table, sids, qk, qv = _skewed_case(cuda, n, 0.3, seed=n)
    _seq_equal(cfg, (table, sids, qk, qv), (), owners=4 * n + 3)


@pytest.mark.parametrize("kw", [dict(num_sets=64, m=2, p=4, value_planes=2),
                                dict(num_sets=32, m=2, p=4, value_planes=1,
                                     cost_planes=1)])
def test_cache_engines_agree_on_the_card(cuda, kw):
    """One-pass == rounds == sequential through the kernels, the sequential
    kernel == the plain sequential loop on a CPU table (an oracle that
    shares no code with the kernels), and the run really launched all three
    kernels."""
    from repro_torch.data.ycsb import zipfian

    cfg = MSLRUConfig(**kw)
    keys = zipfian(8 * cfg.capacity, 4096, seed=5)
    vals = (keys[:, None] * np.arange(1, cfg.value_planes + 1)).astype(np.int32)
    costs = (keys % 7).astype(np.int32) if cfg.cost_planes else None
    caches = {e: MultiStepLRUCache(cfg, engine=e, device=cuda)
              for e in ("onepass", "rounds")}
    seq = MultiStepLRUCache(cfg, device=cuda)
    plain = MultiStepLRUCache(cfg, device="cpu")
    before = dict(msl_cache.LAUNCHES)
    for i in range(0, len(keys), 1024):
        q = slice(i, i + 1024)
        c = None if costs is None else costs[q]
        want = seq.access_seq(keys[q], vals[q], costs=c)
        ref = plain.access_seq(keys[q], vals[q], costs=c)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(want, f).cpu().numpy(),
                                          getattr(ref, f).numpy(), err_msg=f"seq: {f}")
        for e, cache in caches.items():
            got = cache.access(keys[q], vals[q], costs=c)
            for f in ("hit", "pos", "evicted_key", "evicted_valid"):
                np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                              getattr(want, f).cpu().numpy(),
                                              err_msg=f"{e}: {f}")
    for cache in (*caches.values(), plain):
        np.testing.assert_array_equal(table_to_numpy(cache.table),
                                      table_to_numpy(seq.table))
    assert msl_cache.LAUNCHES["msl_onepass"] > before["msl_onepass"]
    assert msl_cache.LAUNCHES["msl_access"] > before["msl_access"]
    assert msl_cache.LAUNCHES["msl_seq"] == before["msl_seq"] + len(keys) // 1024


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


@pytest.mark.parametrize("kw,match", [(dict(m=8, p=8, value_planes=0), "A = 64"),
                                      (dict(m=2, p=4, value_planes=8), "C = 9")])
def test_seq_kernel_refuses_wide_sets_and_planes(cuda, kw, match):
    """The sequential kernel holds a row in one warp and at most 8 planes a
    lane: A > 32 and C > 8 raise before a launch."""
    cfg = MSLRUConfig(num_sets=4, **kw)
    table = init_table(cfg, cuda)
    keys = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    vals = torch.zeros((2, cfg.value_planes), dtype=torch.int32, device=cuda)
    before = msl_cache.LAUNCHES["msl_seq"]
    with pytest.raises(ValueError, match=match):
        msl_cache.msl_seq_kernel_call(table, set_index_for(cfg, keys), keys, vals, cfg=cfg)
    assert msl_cache.LAUNCHES["msl_seq"] == before


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def paged_case(seed, *, b=4, h=8, kvh=4, dh=64, pt=16, n_pages=24, npg=6, tmax=48,
               plens=(32, 0, 48, 16), used=(9, 30, 0, 20)):
    """Random pool, tails, block tables and row lengths as numpy: row i has
    plens[i] prefix tokens in pages and used[i] + 1 tail tokens (the new
    token included), so cur_len = plen + used."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    plens = np.array(plens[:b], np.int32)
    return dict(q=f(b, h, dh), pool_k=f(n_pages, pt, kvh, dh), pool_v=f(n_pages, pt, kvh, dh),
                block_table=rng.integers(0, n_pages, (b, npg)).astype(np.int32),
                tail_k=f(b, tmax, kvh, dh), tail_v=f(b, tmax, kvh, dh),
                prefix_len=plens, cur_len=plens + np.array(used[:b], np.int32))


def paged_args(case, device):
    bf = {"q", "pool_k", "pool_v", "tail_k", "tail_v"}
    return [torch.from_numpy(case[k]).to(device, torch.bfloat16 if k in bf else torch.int32)
            for k in ("q", "pool_k", "pool_v", "block_table", "tail_k", "tail_v",
                      "prefix_len", "cur_len")]


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (24, 0.0), (None, 30.0), (24, 30.0)])
@pytest.mark.parametrize("h,kvh,dh", [(8, 4, 64), (4, 4, 96), (8, 2, 128), (32, 32, 96)])
def test_paged_kernel_matches_plain(cuda, h, kvh, dh, window, softcap):
    """The kernel against its plain version, with the JAX package's gate
    for its Pallas kernel against the jnp mirror (rtol 0.05, atol 0.02):
    the kernel's scores stay f32 where the plain version rounds them to
    bf16, and it accumulates flash-style."""
    args = paged_args(paged_case(3, h=h, kvh=kvh, dh=dh), cuda)
    before = paged_attn.LAUNCHES["paged_attn"]
    got = paged_attn.paged_attn_decode_call(*args, window=window, softcap=softcap)
    assert paged_attn.LAUNCHES["paged_attn"] == before + 1
    want = paged_attn.paged_attn_decode_plain(*args, window=window, softcap=softcap)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0.05, atol=0.02)


# (h, kvh, dh, window): the head dims and GQA ratios the attention-decoder
# families add: Dh 16 and 24 (smoke configs, one or no chunk per quarter),
# Dh 32 rep 4 on one KV head (gemma3-smoke), rep 9 at Dh 128 (starcoder2-7b:
# more value-pass slots than threads), rep 8 (command-r-35b, qwen2-vl-72b),
# Dh 256 (gemma3-1b, dynamic shared memory) and rep 16 (the most built)
FAMILY_CASES = [(8, 2, 16, None), (6, 2, 24, 32), (4, 1, 32, 16), (36, 4, 128, None),
                (64, 8, 128, None), (4, 1, 256, None), (4, 1, 256, 40), (16, 1, 64, None),
                (32, 2, 256, 24)]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("h,kvh,dh,window", FAMILY_CASES)
def test_paged_kernel_takes_every_family_shape(cuda, h, kvh, dh, window, softcap):
    """Each new (Dh, rep) against the plain version, within the JAX
    package's gate: rows with a prefix, with none, with a one-token tail."""
    args = paged_args(paged_case(6, h=h, kvh=kvh, dh=dh), cuda)
    before = paged_attn.LAUNCHES["paged_attn"]
    got = paged_attn.paged_attn_decode_call(*args, window=window, softcap=softcap)
    assert paged_attn.LAUNCHES["paged_attn"] == before + 1
    want = paged_attn.paged_attn_decode_plain(*args, window=window, softcap=softcap)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0.05, atol=0.02)


# (h, kvh, dh, plens, used, window): rows of up to 256 positions (one of
# 400, so that a block walks two tiles), lengths that are no multiple of
# the cluster's split, windows whose first position falls inside a split
CLUSTER_CASES = [
    (32, 32, 96, (208, 0, 96, 33), (47, 40, 0, 11), None),
    (8, 2, 128, (208, 0, 96, 33), (47, 255, 0, 11), 100),
    (16, 4, 64, (176, 16, 0, 80), (79, 3, 190, 0), 37),
    (8, 8, 32, (384, 0, 224, 16), (15, 1, 31, 200), None),
    (36, 4, 128, (208, 0, 96, 33), (47, 255, 0, 11), None),
    (4, 1, 256, (384, 0, 224, 16), (15, 1, 31, 200), 100),
    (8, 2, 16, (176, 16, 0, 80), (79, 3, 190, 0), 37),
]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("h,kvh,dh,plens,used,window", CLUSTER_CASES)
def test_paged_kernel_splits_rows_over_a_cluster(cuda, h, kvh, dh, plens, used, window,
                                                 softcap):
    """Rows long enough to spread over several cluster ranks, within the
    JAX package's gate (rtol 0.05, atol 0.02) of the plain version."""
    npg = (max(plens) + 15) // 16 + 1
    case = paged_case(5, h=h, kvh=kvh, dh=dh, n_pages=64, npg=npg, tmax=256,
                      plens=plens, used=used)
    args = paged_args(case, cuda)
    assert paged_attn.kernel_splits(args[0], args[1], args[3], args[4], window=window) > 1
    got = paged_attn.paged_attn_decode_call(*args, window=window, softcap=softcap)
    # the plain version's view holds every position of every row
    want = paged_attn.paged_attn_decode_plain(*args, window=window, softcap=softcap,
                                              smax=npg * 16 + 256)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0.05, atol=0.02)


def test_paged_kernel_refuses_what_it_was_not_built_for(cuda):
    args = paged_args(paged_case(4, h=4, kvh=4, dh=80), cuda)
    with pytest.raises(ValueError, match="head dim 80"):
        paged_attn.paged_attn_decode_call(*args)
    args = paged_args(paged_case(4, h=6, kvh=4, dh=64), cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        paged_attn.paged_attn_decode_call(*args)
    args = paged_args(paged_case(4, h=17, kvh=1, dh=64), cuda)
    with pytest.raises(ValueError, match="17 > 16"):
        paged_attn.paged_attn_decode_call(*args)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-1b", "starcoder2-7b",
                                  "command-r-35b", "qwen2-vl-72b"])
def test_paged_serving_runs_the_kernel_on_the_card(cuda, arch):
    """The launcher's paged path at smoke size on the card, for each
    architecture: one kernel launch per layer per decode launch, one
    one-pass launch per prefix-cache call, no prefix copy."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(["--kv-mode", "paged", "--device", "cuda",
                                      "--requests", "8", "--arch", arch])
    eng = serve.build(args)
    for req in serve.make_requests(eng.cfg, args):
        eng.submit(req)
    before = {**paged_attn.LAUNCHES, **msl_cache.LAUNCHES}
    eng.run_until_done()
    st = eng.stats()
    assert len(eng.finished) == 8 and st["gather_calls"] == 0
    assert (paged_attn.LAUNCHES["paged_attn"] - before["paged_attn"]
            == eng.cfg.n_layers * st["decode_launches"] > 0)
    assert (msl_cache.LAUNCHES["msl_onepass"] - before["msl_onepass"]
            == eng.prefix_cache.device_calls > 0)


def _megastep_engine(requests=8):
    """The launcher's paged megastep engine at smoke size on the card, after
    its first tick (every slot live, each on a cached template prefix)."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(["--kv-mode", "paged", "--device", "cuda",
                                      "--decode-mode", "megastep", "--requests",
                                      str(requests)])
    eng = serve.build(args)
    for req in serve.make_requests(eng.cfg, args):
        eng.submit(req)
    eng.step()
    assert len(eng.active) == eng.slots
    return eng, args


def test_captured_window_matches_the_eager_loop(cuda):
    """A window replayed from its captured graph equals the eager
    ``megastep_decode`` loop on the card: the same packed result (tokens,
    emits, cur_len, live) and the same tail bits.  Capture's warm-up
    launches the kernel once per layer and step; the capture itself
    launches nothing; each replay adds n_layers x steps launches; a second
    window of the bucket replays the same graph."""
    eng, _ = _megastep_engine()
    steps, n_layers = 4, eng.cfg.n_layers
    x = eng._window_inputs(3)
    snap = {k: v.clone() for k, v in eng.cache.items()}
    eager = eng._window_body(torch.from_numpy(x).to(cuda), steps)
    eager_tail = {k: v.clone() for k, v in eng.cache.items()}
    for k in snap:
        eng.cache[k].copy_(snap[k])
    before = paged_attn.LAUNCHES["paged_attn"]
    win = eng.capture_window(steps)
    assert paged_attn.LAUNCHES["paged_attn"] - before == n_layers * steps  # warm-up
    assert win.launches == {"paged_attn": n_layers * steps}
    for k in snap:
        eng.cache[k].copy_(snap[k])
    for _ in range(2):
        before = paged_attn.LAUNCHES["paged_attn"]
        got = eng._run_window(steps, x).clone()
        torch.cuda.synchronize()
        assert paged_attn.LAUNCHES["paged_attn"] - before == n_layers * steps
        assert torch.equal(got, eager)
        for k in snap:
            assert torch.equal(eng.cache[k], eager_tail[k])
            eng.cache[k].copy_(snap[k])
        assert eng.window_graphs == {steps: win}
    toks = eager[:steps].cpu().numpy()
    assert (toks[:3] >= 0).all() and (toks[3:] == -1).all()


def test_replay_reads_new_block_tables(cuda):
    """The block tables ride the operand vector: after a row's table
    changes (its prefix pages swapped for others), a replay of the same
    graph equals the eager loop on the new tables and differs from the
    replay on the old ones."""
    eng, _ = _megastep_engine()
    steps = 2
    snap = {k: v.clone() for k, v in eng.cache.items()}
    old = eng._run_window(steps, eng._window_inputs(steps)).clone()
    for k in snap:
        eng.cache[k].copy_(snap[k])
    row = int(np.flatnonzero(eng.pool.prefix_lens)[0])
    n = int(eng.pool.prefix_lens[row]) // eng.pool.page_tokens
    fresh = [p for p in range(eng.pool.n_pages) if eng.pool.refcount[p] == 0][:n]
    eng.pool.k[:, fresh] = torch.randn_like(eng.pool.k[:, fresh])
    eng.pool.v[:, fresh] = torch.randn_like(eng.pool.v[:, fresh])
    eng.pool.block_tables[row, :n] = fresh
    x = eng._window_inputs(steps)
    eager = eng._window_body(torch.from_numpy(x).to(cuda), steps)
    for k in snap:
        eng.cache[k].copy_(snap[k])
    got = eng._run_window(steps, x)
    assert list(eng.window_graphs) == [steps]
    assert torch.equal(got, eager)
    assert not torch.equal(got[:steps, row], old[:steps, row])


def test_megastep_serving_on_the_card(cuda):
    """The launcher's paged megastep engine at smoke size: the in-flight
    engine's tokens, ticks and finish order through captured graphs, with
    n_layers launches per in-flight decode launch and per window step."""
    from repro_torch.launch import serve

    eng_m, args = _megastep_engine(requests=12)
    eng_i = serve.build(serve.parser().parse_args(
        ["--kv-mode", "paged", "--device", "cuda", "--requests", "12"]))
    for req in serve.make_requests(eng_i.cfg, args):
        eng_i.submit(req)
    eng_i.run_until_done()
    before = paged_attn.LAUNCHES["paged_attn"]
    d0, w0 = eng_m.decode_launches, eng_m.megastep_windows
    eng_m.run_until_done()
    graphs = eng_m.window_graphs
    warmups = sum(w.launches["paged_attn"] for w in graphs.values())
    st_m, st_i = eng_m.stats(), eng_i.stats()
    assert {r.rid: r.out_tokens for r in eng_m.finished} == \
        {r.rid: r.out_tokens for r in eng_i.finished}
    assert [r.rid for r in eng_m.finished] == [r.rid for r in eng_i.finished]
    assert st_m["ticks"] == st_i["ticks"] and st_m["megastep_windows"] > 0
    assert st_m["decode_launches"] < st_i["decode_launches"]
    inflight = (st_m["decode_launches"] - d0) - (st_m["megastep_windows"] - w0)
    assert (paged_attn.LAUNCHES["paged_attn"] - before - warmups
            == eng_m.cfg.n_layers * (inflight + st_m["megastep_steps"]))


def _sharded_run(device, ndev, engine, cap, batches):
    """The sharded engine over ``batches`` on ``device``: per batch (hit,
    value, served, evicted) and the final table, as numpy."""
    from repro_torch.core.sharded import make_sharded_engine, shard_table
    from repro_torch.launch.mesh import make_cache_mesh

    cfg = MSLRUConfig(num_sets=64, m=2, p=4, value_planes=1)
    mesh = make_cache_mesh(ndev, device=device)
    run = make_sharded_engine(cfg, mesh, cap=cap, engine=engine)
    t = shard_table(init_table(cfg, device), mesh)
    outs = []
    for keys, vals, ops, cids, order in batches:
        args = [torch.from_numpy(x).to(device) if x is not None else None
                for x in (keys, vals, ops, cids, order)]
        out = run(t, *args[:4], order=args[4])
        t = out[0]
        outs.append([x.cpu().numpy() for x in out[1:]])
    return outs, t.cpu().numpy()


@pytest.mark.parametrize("engine", ["onepass", "rounds"])
@pytest.mark.parametrize("ndev,cap", [(2, "full"), (7, "full"), (8, "full"), (8, 2.0)])
def test_sharded_engine_on_the_card(cuda, engine, ndev, cap):
    """The sharded engine's logical shards on the card (each update through
    its kernel) against the same engine on
    the CPU (held against the JAX package by test_torch_sharded.py):
    mixed-opcode batches, and chain batches with an ``order`` plane;
    results, served masks and tables bit-equal."""
    from torch_sharded_cases import chain_batch, engine_batches

    q = 16 * ndev
    batches = [(k, v, o, None, None) for k, v, o in engine_batches(ndev, 3, q, True)]
    # a chain per 16-row slab (GET island, PUT island, LOOKUP padding on key
    # 0), slab-local chain id 0, the slabs ranked in reverse by ``order``
    rng = np.random.default_rng(ndev)
    slabs = []
    for d in range(ndev):
        chain = [int(h) | 1 for h in rng.integers(1, 2**30, 3)]
        k, v, o, c = chain_batch([chain], [[100 + 3 * d + i for i in range(3)]])
        n = 16 - len(k)
        slabs.append((np.concatenate([k, np.zeros(n, np.int32)]),
                      np.concatenate([v[:, 0], np.zeros(n, np.int32)]),
                      np.concatenate([o, np.full(n, 3, np.int32)]),
                      np.concatenate([c, np.zeros(n, np.int32)])))
    keys, vals, ops, cids = (np.concatenate(x) for x in zip(*slabs))
    order = (np.arange(q) % 16 + (ndev - 1 - np.arange(q) // 16) * 16).astype(np.int32)
    batches += [(keys[:, None], vals[:, None], ops, cids, order)] * 2
    got, got_t = _sharded_run("cuda", ndev, engine, cap, batches)
    want, want_t = _sharded_run("cpu", ndev, engine, cap, batches)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    assert np.array_equal(got_t, want_t)


def test_sharded_serving_on_the_card(cuda):
    """``serve.build`` with ``--sharded 8 --cap 2 --placement split
    --throttle-threshold 0.75 --chaos-seed 5`` at smoke size on the card:
    every request served in full, and the ticks, fault log, counters and
    prefill split of the same serve on the CPU (the schedule does not
    depend on the tokens); the pool ends balanced."""
    from repro_torch.launch import serve

    flags = ["--kv-mode", "paged", "--sharded", "8", "--cap", "2", "--placement", "split",
             "--throttle-threshold", "0.75", "--chaos-seed", "5"]
    runs = []
    for device in ("cuda", "cpu"):
        args = serve.parser().parse_args(flags + ["--device", device])
        eng = serve.build(args)
        for r in serve.make_requests(eng.cfg, args):
            eng.submit(r)
        eng.run_until_done(fault_plan=serve.fault_plan(args))
        st = eng.stats()
        pool = eng.pool
        assert pool.free_pages + int(pool.refcount.sum()) == pool.n_pages
        assert all(len(r.out_tokens) == args.max_new for r in eng.finished)
        runs.append((eng.ticks, eng.fault_log,
                     [(r.rid, r.prefill_skipped) for r in eng.finished],
                     {k: st[k] for k in ("fallbacks", "partial_served", "split_chains",
                                          "throttled_admissions", "partial_sheds")},
                     eng.prefix_cache.stats()["shed"]))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# The distributed layer's device code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["onepass", "rounds"])
def test_route_on_the_card_equals_the_direct_engine(cuda, engine):
    """The route over an in-process ``CacheMesh`` on the card (each kernel
    fed the routed planes) gives the direct engine's planes and table, at
    a full and a bounded per-peer depth, with opcodes."""
    from repro_torch.core.sharded import make_routed_engine, make_sharded_engine, shard_table
    from repro_torch.launch.mesh import make_cache_mesh

    cfg = MSLRUConfig(num_sets=512, m=2, p=4, value_planes=2)
    mesh = make_cache_mesh(8, device="cuda")
    rng = np.random.default_rng(3)
    for cap in ("full", 24):
        direct = make_sharded_engine(cfg, mesh, cap=cap, engine=engine)
        routed = make_routed_engine(cfg, mesh, cap=cap, engine=engine)
        a = shard_table(init_table(cfg, "cuda"), mesh)
        b = a.clone()
        for _ in range(3):
            keys = torch.from_numpy(rng.integers(1, 3000, (1024, 1)).astype(np.int32)).cuda()
            vals = torch.cat([keys, -keys], 1)
            ops = torch.from_numpy(rng.integers(0, 4, 1024).astype(np.int32)).cuda()
            got, want = routed(b, keys, vals, ops), direct(a, keys, vals, ops)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (cap, engine)
            a, b = want[0], got[0]


def test_quantize_int8_on_the_card_equals_the_cpu(cuda):
    """``quantize_int8``/``dequantize_int8`` on the card bit-equal to the
    CPU (whose arithmetic equals JAX's), the scale an IEEE quotient on
    both, over 64 seeded tensors of different maxima."""
    from repro_torch.train.compression import dequantize_int8, quantize_int8

    gen = torch.Generator().manual_seed(0)
    for i in range(64):
        x = torch.randn(4096, generator=gen) * float(torch.rand((), generator=gen)) * 10 ** (i % 5)
        q, s = quantize_int8(x)
        qd, sd = quantize_int8(x.to(cuda))
        assert torch.equal(qd.cpu(), q) and sd.cpu().view(torch.int32) == s.view(torch.int32)
        assert torch.equal(dequantize_int8(qd, sd).cpu(), dequantize_int8(q, s))
