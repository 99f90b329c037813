"""The port's sharded cache against the JAX package's, on the CPU.

``make_sharded_engine`` runs D logical shards in one process, so it is held
in process against the JAX package's local ``MultiStepLRUCache`` (the
contract the JAX sharded engine meets against its sequential engine): at
D = 1, 2, 7 and 8, in plain, mixed-opcode, chain (with ``order``) and cost
modes, tables bit-equal and hit, value, served and eviction planes equal.
The JAX sharded engine and client need D devices, fixed when JAX starts,
so two children (D = 8 and D = 2 fake CPU devices, started together when
this module's first test runs) record the JAX side: the bounded-cap
engine's served masks, and seeded multi-tick chain sequences through
``ShardedCacheClient`` with faults and a reshard; the port replays the same
inputs (``tests/torch_sharded_cases.py``) and every record must be equal.
The elastic plans are compared in process.
"""

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import MSLRUConfig as JaxConfig
from repro.core import init_table as jax_init_table
from repro.core import make_batched_engine as make_jax_batched_engine
from repro.core import sharded as jsharded
from repro.launch import elastic as jelastic
from repro.launch.mesh import make_cache_mesh as jax_cache_mesh
from repro_torch.core import (EMPTY_KEY, MSLRUConfig, OP_CHAIN_GET, OP_CHAIN_PUT,
                              OP_LOOKUP, init_table, make_conflict_update,
                              set_index_for)
from repro_torch.core.sharded import (ShardedCacheClient, make_sharded_engine,
                                      make_sharded_stream_runner, per_peer_cap,
                                      sets_per_shard, shard_table)
from repro_torch.launch import elastic
from repro_torch.launch.mesh import CacheMesh, make_cache_mesh

import torch_sharded_cases as cases

ROOT = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# the JAX children: started together at the module's first test
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, sys, pickle
ndev, reshard_to, seed, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % ndev
sys.path[:0] = ["src", "tests"]
import numpy as np, jax, jax.numpy as jnp
from repro.core import MSLRUConfig, init_table
from repro.core.sharded import ShardedCacheClient, make_sharded_engine, shard_table
from repro.launch.mesh import make_cache_mesh
import torch_sharded_cases as cases

rec = {"engine": {}, "client": {}}
mesh = make_cache_mesh(ndev)
for cap, mixed in [tuple(x) for x in eval(sys.argv[5])]:
    cfg = MSLRUConfig(**cases.CFG)
    run = make_sharded_engine(cfg, mesh, cap=cap, engine="onepass")
    t = shard_table(init_table(cfg), mesh)
    outs = []
    for keys, vals, ops in cases.engine_batches(seed, 3, 32 * ndev, mixed):
        t, hit, val, served = run(t, jnp.asarray(keys), jnp.asarray(vals),
                                  None if ops is None else jnp.asarray(ops))
        outs.append({"hit": np.asarray(hit), "val": np.asarray(val),
                     "served": np.asarray(served)})
    rec["engine"][(cap, mixed)] = {"batches": outs,
                                   "table": np.asarray(jax.device_get(t))[:cfg.num_sets]}
for cap, placement in [tuple(x) for x in eval(sys.argv[6])]:
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh, cap=cap, placement=placement)
    rec["client"][(cap, placement)] = cases.drive_client(
        cl, cases.client_steps(seed, ndev, reshard_to=reshard_to),
        lambda c: np.asarray(jax.device_get(c.table)))
with open(out, "wb") as f:
    pickle.dump(rec, f)
"""

SEED = 3
# (ndev, reshard_to, engine cases (cap, mixed), client cases (cap, placement))
FAST = {8: (5, [(2.0, False), (3, True)], [(1.0, "split")]),
        2: (1, [], [(0.5, "roundrobin")])}
SWEEP = [(c, p) for c in cases.CAPS for p in cases.PLACEMENTS]


class _Child:
    """One JAX child process and the record it writes."""

    def __init__(self, ndev, reshard_to, engine_cases, client_cases, path):
        self.path = path
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(ndev), str(reshard_to), str(SEED), str(path),
             repr(engine_cases), repr(client_cases)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._rec = None

    def record(self):
        if self._rec is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.path, "rb") as f:
                self._rec = pickle.load(f)
        return self._rec


@pytest.fixture(scope="module", autouse=True)
def jax_children(tmp_path_factory):
    """The fast lane's D = 8 and D = 2 children, running while the in-process
    tests below run."""
    d = tmp_path_factory.mktemp("sharded")
    children = {nd: _Child(nd, *spec, d / f"d{nd}.pkl") for nd, spec in FAST.items()}
    yield children
    for c in children.values():
        if c.proc.poll() is None:
            c.proc.kill()
            c.proc.communicate()


def _port_client(ndev, cap, placement, reshard_to):
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(ndev, "cpu"),
                            cap=cap, placement=placement)
    return cases.drive_client(cl, cases.client_steps(SEED, ndev, reshard_to=reshard_to),
                              lambda c: c.table.cpu().numpy())


# ---------------------------------------------------------------------------
# geometry, mesh, elastic plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_sets,ndev", [(64, 1), (64, 7), (256, 8), (1024, 13), (2**21, 8)])
def test_geometry_matches_jax(num_sets, ndev):
    """``sets_per_shard``, ``per_peer_cap`` under every cap form, and
    ``plan_cache_remesh`` with and without degraded shards, equal JAX's."""
    assert sets_per_shard(num_sets, ndev) == jsharded.sets_per_shard(num_sets, ndev)
    for cap in ("full", None, 2.0, 0.5, 1.0, 3, 1):
        for q in (1, 8, 40, 8192):
            assert per_peer_cap(cap, q, ndev) == jsharded.per_peer_cap(cap, q, ndev)
    for degraded in [None] + ([{0}, set(range(ndev - 1))] if ndev > 1 else []):
        assert (elastic.plan_cache_remesh(ndev, num_sets, degraded)
                == jelastic.plan_cache_remesh(ndev, num_sets, degraded))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_fault_plans_match_jax(ndev):
    """``FaultPlan.seeded`` gives the JAX package's events for 50 seeds, and
    pops them at the same ticks."""
    for seed in range(50):
        for n_events in (3, 6):
            got = elastic.FaultPlan.seeded(seed, ticks=24, ndev=ndev, n_events=n_events)
            want = jelastic.FaultPlan.seeded(seed, ticks=24, ndev=ndev, n_events=n_events)
            assert [vars(e) for e in got.events] == [vars(e) for e in want.events]
            for t in range(0, 26, 5):
                assert ([vars(e) for e in got.pop_due(t)]
                        == [vars(e) for e in want.pop_due(t)])
                assert got.next_tick() == want.next_tick()
    with pytest.raises(ValueError, match="fault kind"):
        elastic.FaultEvent(1, "meteor", 0)


def test_mesh_all_to_all_is_the_transpose():
    """``all_to_all`` hands shard d the buffers every shard addressed to d:
    recv[d, s] = send[s, d], for D = 3 (asymmetric contents)."""
    mesh = make_cache_mesh(3, device="cpu")
    assert isinstance(mesh, CacheMesh) and mesh.shape == {"cache": 3}
    send = torch.arange(3 * 3 * 2 * 4, dtype=torch.int32).view(3, 3, 2, 4)
    recv = mesh.all_to_all(send)
    for d in range(3):
        for s in range(3):
            assert torch.equal(recv[d, s], send[s, d])
    with pytest.raises(ValueError, match="send buffers"):
        mesh.all_to_all(send[:2])
    assert make_cache_mesh(device="cpu").shape == {"cache": 1}


def test_shard_table_pads_with_empty_sets():
    """D = 7 does not divide 64 sets: the table pads to 7 * 10 rows of EMPTY
    sets (as the JAX package's ``shard_table``); ``dummy`` appends one row."""
    cfg = MSLRUConfig(**cases.CFG)
    t = init_table(cfg, "cpu")
    t[:, 0, 0] = torch.arange(64, dtype=torch.int32) + 1
    mesh = make_cache_mesh(7, "cpu")
    s = shard_table(t, mesh)
    assert s.shape == (70, cfg.assoc, cfg.planes)
    assert torch.equal(s[:64], t)
    assert (s[64:, :, 0] == EMPTY_KEY).all() and (s[64:, :, 1:] == 0).all()
    assert shard_table(t.numpy(), mesh, dummy=True).shape[0] == 71


# ---------------------------------------------------------------------------
# the engine in process, against the JAX package's local cache
# ---------------------------------------------------------------------------

def _chain_slabs(rng, ndev, q):
    """Per slab a serving tick (GET island, PUT island) with slab-local
    chain ids, padded with LOOKUP rows on key 0; chains draw from shared
    templates, so slabs duplicate each other's chunks."""
    templates = [cases._hashes(rng, int(rng.integers(2, 5))) for _ in range(4)]
    keys, vals, ops, cids = [], [], [], []
    page = 1000 * int(rng.integers(1, 99))
    for _ in range(ndev):
        chains = [templates[int(rng.integers(4))][: int(rng.integers(1, 5))]
                  + cases._hashes(rng, int(rng.integers(0, 2)))
                  for _ in range(1 if q < 24 else 2)]
        staged = []
        for c in chains:
            staged.append(list(range(page, page + len(c))))
            page += len(c)
        k, v, o, c = cases.chain_batch(chains, staged)
        n = q - len(k)
        keys.append(np.concatenate([k, np.zeros(n, np.int32)]))
        vals.append(np.concatenate([v[:, 0], np.zeros(n, np.int32)]))
        ops.append(np.concatenate([o, np.full(n, OP_LOOKUP, np.int32)]))
        cids.append(np.concatenate([c, np.zeros(n, np.int32)]))
    return (np.concatenate(keys)[:, None], np.concatenate(vals)[:, None],
            np.concatenate(ops), np.concatenate(cids))


Q = 112     # queries per batch at every D (1, 2, 7 and 8 divide it)


def _engine_batches(mode, ndev, seed, n_batches=3):
    """(keys, vals, ops, chain_ids, order, costs) per batch of ``Q``
    queries; ``order`` ranks the slabs in reverse, so the canonical sort
    permutes whole slabs."""
    rng = np.random.default_rng(seed)
    q = Q // ndev
    out = []
    for _ in range(n_batches):
        if mode == "chain":
            keys, vals, ops, cids = _chain_slabs(rng, ndev, q)
            order = (np.arange(Q) % q + (ndev - 1 - np.arange(Q) // q) * q).astype(np.int32)
            out.append((keys, vals, ops, cids, order, None))
            continue
        keys = rng.integers(1, 300, (Q, 1)).astype(np.int32)
        ops = rng.integers(0, 4, Q).astype(np.int32) if mode == "mixed" else None
        costs = rng.integers(0, 40, Q).astype(np.int32) if mode == "cost" else None
        out.append((keys, keys + 5, ops, None, None, costs))
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine(kw_items):
    """One JAX batched engine per geometry, shared by the tests, so each
    (shape, operand set) compiles once."""
    cfg = JaxConfig(**dict(kw_items))
    return cfg, make_jax_batched_engine(cfg, engine="onepass")


def _jax_reference(kw, batches, ndev):
    """The JAX local cache over the same batches, in caller-rank order, with
    slab-local chain ids made global."""
    cfg, run = _jax_engine(tuple(sorted(kw.items())))
    table = jax_init_table(cfg)
    q = len(batches[0][0]) // ndev
    outs = []
    for keys, vals, ops, cids, order, costs in batches:
        perm = np.arange(len(keys)) if order is None else np.argsort(order, kind="stable")
        gc = None if cids is None else (cids + (np.arange(len(keys)) // q) * q).astype(np.int32)
        table, r = run(table, jnp.asarray(keys[perm]), jnp.asarray(vals[perm]),
                       None if ops is None else jnp.asarray(ops[perm]),
                       None if gc is None else jnp.asarray(gc[perm]),
                       None if costs is None else jnp.asarray(costs[perm]))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        outs.append({f: np.asarray(getattr(r, f))[inv] for f in
                     ("hit", "value", "evicted_valid", "evicted_val")})
    return outs, np.asarray(table)


ENGINE_CASES = [(d, m, "onepass") for d in (1, 2, 7, 8)
                for m in ("plain", "mixed", "chain", "cost")]
ENGINE_CASES += [(2, "mixed", "rounds"), (2, "chain", "rounds"), (8, "cost", "rounds")]


@pytest.mark.parametrize("ndev,mode,engine", ENGINE_CASES)
def test_engine_matches_jax_local_cache(ndev, mode, engine):
    """Full cap: the sharded engine's table bit-equal to the JAX local
    cache's after every batch, and hit, value (on hits), served and, in
    chain mode, the evicted planes equal; with ``order`` the local cache is
    fed the batch in rank order."""
    kw = dict(cases.CFG, cost_planes=1 if mode == "cost" else 0)
    cfg = MSLRUConfig(**kw)
    batches = _engine_batches(mode, ndev, seed=ndev * 7 + len(mode))
    want, want_table = _jax_reference(kw, batches, ndev)
    mesh = make_cache_mesh(ndev, "cpu")
    run = make_sharded_engine(cfg, mesh, cap="full", engine=engine)
    t = shard_table(init_table(cfg, "cpu"), mesh)
    for (keys, vals, ops, cids, order, costs), w in zip(batches, want):
        out = run(t, keys, vals, ops, cids, order=order, costs=costs)
        t, hit, val, served = out[:4]
        assert served.all()
        assert np.array_equal(hit.numpy(), w["hit"])
        assert np.array_equal(val.numpy()[w["hit"]], w["value"][w["hit"]])
        if cids is not None:
            assert np.array_equal(out[5].numpy(), w["evicted_valid"])
            ok = w["evicted_valid"]
            assert np.array_equal(out[4].numpy()[ok], w["evicted_val"][ok])
    assert t.shape[0] == ndev * sets_per_shard(cfg.num_sets, ndev)
    assert np.array_equal(t[: cfg.num_sets].numpy(), want_table)
    assert (t[cfg.num_sets:, :, 0] == EMPTY_KEY).all()


@pytest.mark.parametrize("cap", ["full", 8])
def test_asymmetric_route_on_two_shards(cap):
    """D = 2 with slab 0 sending only to shard 1 and slab 1 to both: a
    rank taken over the wrong axis would still look plausible on symmetric
    traffic.  At a per-peer depth of 8, slab 0 keeps its first 8 queries
    and slab 1 its 6 to shard 0 and first 8 to shard 1; the served queries
    give what the JAX local cache gives fed only them, twice over."""
    cfg = MSLRUConfig(**cases.CFG)
    mesh = make_cache_mesh(2, "cpu")
    s_local = sets_per_shard(cfg.num_sets, 2)
    cand = np.arange(1, 4000, dtype=np.int32)
    owner = set_index_for(cfg, torch.from_numpy(cand[:, None])).numpy() // s_local
    to1, to0 = cand[owner == 1], cand[owner == 0]
    keys = np.concatenate([to1[:16], to0[:6], to1[16:26]])[:, None]   # slab 1: 6 + 10
    want_served = np.ones(32, bool)
    if cap != "full":
        want_served[8:16] = want_served[30:] = False
    kept = keys[want_served]
    want, want_table = _jax_reference(cases.CFG, [(kept, kept, None, None, None, None)] * 2, 1)
    run = make_sharded_engine(cfg, mesh, cap=cap, engine="onepass")
    t = shard_table(init_table(cfg, "cpu"), mesh)
    for w in want:
        t, hit, val, served = run(t, keys, keys)
        assert np.array_equal(served.numpy(), want_served)
        assert np.array_equal(hit.numpy()[want_served], w["hit"])
        assert not hit[~torch.from_numpy(want_served)].any()
    assert want[1]["hit"].all() and np.array_equal(t.numpy(), want_table)


@pytest.mark.parametrize("engine", ["onepass", "rounds"])
def test_one_update_equals_per_shard_updates(engine):
    """Shards own disjoint sets, so the engine's single update over the
    padded (D * s_local, A, C) table keyed by the global set id equals D
    updates, one per shard, each over its own rows with local set ids."""
    cfg = MSLRUConfig(**cases.CFG)
    ndev, s_local = 7, sets_per_shard(cfg.num_sets, 7)
    rng = np.random.default_rng(5)
    keys = rng.integers(1, 400, (300, 1)).astype(np.int32)
    ops = rng.integers(0, 4, 300).astype(np.int32)
    k = torch.from_numpy(keys)
    gsid = set_index_for(cfg, k)
    owner = gsid // s_local
    table = shard_table(init_table(cfg, "cpu"), make_cache_mesh(ndev, "cpu"))
    update = make_conflict_update(cfg, engine)
    valid = torch.ones(300, dtype=torch.bool)
    for _ in range(2):
        whole, res, _ = update(table, gsid, valid, k, k, torch.from_numpy(ops))
        parts = []
        for d in range(ndev):
            rows = owner == d
            part, r_d, _ = update(table[d * s_local:(d + 1) * s_local], gsid[rows] % s_local,
                                  valid[rows], k[rows], k[rows], torch.from_numpy(ops)[rows])
            parts.append(part)
            assert torch.equal(res.hit[rows], r_d.hit)
            assert torch.equal(res.evicted_valid[rows], r_d.evicted_valid)
        assert torch.equal(whole, torch.cat(parts))
        table = whole


@pytest.mark.parametrize("ndev,mode", [(2, "mixed"), (8, "chain"), (7, "cost")])
def test_stream_runner_matches_jax_local_cache(ndev, mode):
    """``make_sharded_stream_runner`` over a stream of batches: the table
    bit-equal to the JAX local cache's, hits and served counts equal."""
    kw = dict(cases.CFG, cost_planes=1 if mode == "cost" else 0)
    cfg = MSLRUConfig(**kw)
    batches = _engine_batches(mode, ndev, seed=11)
    if mode == "chain":      # the stream runner takes no order plane
        batches = [b[:4] + (None, None) for b in batches]
    want, want_table = _jax_reference(kw, batches, ndev)

    def stack(i):
        parts = [b[i] for b in batches]
        return None if parts[0] is None else torch.from_numpy(np.concatenate(parts))

    run = make_sharded_stream_runner(cfg, make_cache_mesh(ndev, "cpu"), cap="full",
                                     batch=Q, engine="onepass")
    t, hits, served = run(shard_table(init_table(cfg, "cpu"), make_cache_mesh(ndev, "cpu")),
                          stack(0), stack(1), stack(2), stack(3), costs=stack(5))
    assert int(hits) == sum(int(w["hit"].sum()) for w in want)
    assert int(served) == Q * len(batches)
    assert np.array_equal(t[: cfg.num_sets].numpy(), want_table)


# ---------------------------------------------------------------------------
# the client at D = 1 in process: its shed protocol against JAX's
# ---------------------------------------------------------------------------

def _one_device_chains(rng, n):
    c0 = cases._hashes(rng, n)
    c1 = cases._hashes(rng, n)
    keys = np.asarray(c0 + c1 + c0 + c1, np.int32)
    ops = np.asarray([OP_CHAIN_GET] * 2 * n + [OP_CHAIN_PUT] * 2 * n, np.int32)
    vals = np.zeros((4 * n, 1), np.int32)
    vals[2 * n:3 * n, 0] = 10 + np.arange(n)
    vals[3 * n:, 0] = 20 + np.arange(n)
    cids = np.asarray(([0] * n + [1] * n) * 2, np.int32)
    return c0, keys, vals, ops, cids


@pytest.mark.parametrize("n,cap", [(3, 8), (2, 4)])
def test_one_shard_client_sheds_whole_chains_as_jax(n, cap):
    """On one shard every row targets the one peer, so an int cap admits
    the first chain and sheds the second whole (``n = 3, cap = 8``: 6 rows
    fit, 12 do not); ``n = 2, cap = 4``: chain 0 fills the depth exactly and
    the slab's padding rows overflow it, which must not clobber an admitted
    row.  Sheds, results and table equal JAX's; chain 0's inserts landed."""
    rng = np.random.default_rng(2 + n)
    c0, keys, vals, ops, cids = _one_device_chains(rng, n)
    jcl = jsharded.ShardedCacheClient(JaxConfig(**cases.CFG), jax_cache_mesh(1), cap=cap)
    pcl = ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(1, "cpu"), cap=cap)
    recs = []
    for cl in (jcl, pcl):
        res = cl.access(keys, vals, ops=ops, chain_ids=cids)
        shed = np.asarray(cl.last_shed).copy()
        res2 = cl.access(np.asarray(c0, np.int32), ops=np.full(n, OP_LOOKUP, np.int32))
        recs.append((cases._result(res), shed, cl.sheds, cl.shed_groups, cases._result(res2)))
    cases.assert_records_equal(recs[0], recs[1])
    _, shed, sheds, groups, res2 = recs[1]
    assert shed[cids == 1].all() and not shed[cids == 0].any()
    assert (sheds, groups) == (2 * n, 1)
    assert res2["hit"].all() and list(res2["value"][:, 0]) == list(10 + np.arange(n))
    assert np.array_equal(pcl.table.numpy()[:64], np.asarray(jcl.table)[:64])


def test_client_rejects_what_jax_rejects():
    cfg2 = MSLRUConfig(num_sets=64, m=2, p=4, key_planes=2, value_planes=1)
    with pytest.raises(ValueError, match="1-plane keys"):
        ShardedCacheClient(cfg2, make_cache_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="placement"):
        ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(2, "cpu"),
                           placement="random")
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(2, "cpu"))
    assert cl.placement == "load" and cl.mark_degraded(0) == []
    with pytest.raises(RuntimeError, match="every shard degraded"):
        cl.mark_degraded(1)
    assert ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(2, "cpu"),
                              cap=2.0).placement == "split"


# ---------------------------------------------------------------------------
# against the JAX children
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,mixed", FAST[8][1])
def test_bounded_engine_served_masks_match_jax(jax_children, cap, mixed):
    """D = 8 with a bounded per-peer depth (2x the expected load, and a
    fixed 3 under mixed opcodes): served masks, hits, values and the table equal the
    JAX sharded engine's; some queries shed."""
    want = jax_children[8].record()["engine"][(cap, mixed)]
    cfg = MSLRUConfig(**cases.CFG)
    mesh = make_cache_mesh(8, "cpu")
    run = make_sharded_engine(cfg, mesh, cap=cap, engine="onepass")
    t = shard_table(init_table(cfg, "cpu"), mesh)
    shed = 0
    for (keys, vals, ops), w in zip(cases.engine_batches(SEED, 3, 32 * 8, mixed),
                                    want["batches"]):
        t, hit, val, served = run(t, keys, vals, ops)
        assert np.array_equal(served.numpy(), w["served"])
        assert np.array_equal(hit.numpy(), w["hit"])
        assert np.array_equal(val.numpy(), w["val"])
        shed += int((~served).sum())
    assert np.array_equal(t[: cfg.num_sets].numpy(), want["table"])
    assert shed > 0


@pytest.mark.parametrize("ndev,cap,placement",
                         [(nd, c, p) for nd, spec in FAST.items() for c, p in spec[2]])
def test_client_matches_jax(jax_children, ndev, cap, placement):
    """A seeded multi-tick chain sequence through ``ShardedCacheClient``
    with route failures, a degraded shard and a reshard D -> D': every
    result, ``last_shed``, counter, ``slab_pressure`` (float64, exactly),
    orphan list, drain stream and the final table equal JAX's."""
    want = jax_children[ndev].record()["client"][(cap, placement)]
    got = _port_client(ndev, cap, placement, FAST[ndev][0])
    cases.assert_records_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("ndev,reshard_to", [(8, 5), (2, 1)])
def test_client_sweep_matches_jax(tmp_path, ndev, reshard_to):
    """Every cap ("full", 2.0, 1.0, 0.5) x placement (load, roundrobin,
    split) at D = 8 and D = 2, as ``test_client_matches_jax``."""
    want = _Child(ndev, reshard_to, [], SWEEP, tmp_path / "sweep.pkl").record()["client"]
    for cap, placement in SWEEP:
        cases.assert_records_equal(_port_client(ndev, cap, placement, reshard_to),
                                   want[(cap, placement)], f"{cap}/{placement}")
