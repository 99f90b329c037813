"""The sharded cache's route between processes, on the CPU.

``make_routed_engine`` is the JAX package's ``_route``/``_route_back``/
``local_fn``: send buffers of depth k plus a sacrificial overflow column,
an ``all_to_all`` there and back (and the chain probe's pair).

* Over the in-process ``CacheMesh`` (its ``all_to_all`` a transpose) the
  route gives the direct one-process engine's tables, hits, values, served
  masks, chain planes and cost planes on every engine case of
  ``tests/test_torch_sharded.py`` and ``tests/torch_sharded_cases.py``, and
  the client driven through it gives the direct client's record, faults and
  reshards included.
* Over a ``ProcessCacheMesh`` of D = 2 and 4 gloo ranks on the CPU
  (``run_on_ranks``), the engine, the stream runner and the client (every
  rank placing the same batch, feeding its slab, gathering the results)
  give the one-process engine's records, on every rank; ``mark_degraded``
  and ``reshard`` work there as on one process, and a reshard past the
  world's size is refused.
* A JAX child with D = 2 fake devices runs the bounded engine (per-peer
  depths 3 and 16 against slabs of 32: which rows shed, and that the
  overflow column clobbers no admitted row) and the client; the D = 2
  process mesh gives its records.
* ``run_on_ranks`` re-raises a rank's failure while the others wait in a
  collective.  D = 8 runs under ``-m slow``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_sharded_cases as cases
from repro_torch.core import sharded
from repro_torch.launch.mesh import make_cache_mesh, run_on_ranks
from test_torch_sharded import ENGINE_CASES, Q, _engine_batches
from torch_rank_fns import (fail_on_rank, fault_calls, route_rank, run_client, run_engine,
                            run_stream)

ROOT = Path(__file__).resolve().parent.parent
SEED = 5

_CHILD = r"""
import os, sys, pickle
out = sys.argv[1]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path[:0] = ["src", "tests"]
import numpy as np, jax, jax.numpy as jnp
from repro.core import MSLRUConfig, init_table
from repro.core.sharded import ShardedCacheClient, make_sharded_engine, shard_table
from repro.launch.mesh import make_cache_mesh
import torch_sharded_cases as cases

seed = int(sys.argv[2])
mesh = make_cache_mesh(2)
rec = {"engine": [], "client": []}
for cap, mixed in eval(sys.argv[3]):
    cfg = MSLRUConfig(**cases.CFG)
    run = make_sharded_engine(cfg, mesh, cap=cap, engine="onepass")
    t = shard_table(init_table(cfg), mesh)
    outs = []
    for keys, vals, ops in cases.engine_batches(seed, 3, 64, mixed):
        t, hit, val, served = run(t, jnp.asarray(keys), jnp.asarray(vals),
                                  None if ops is None else jnp.asarray(ops))
        outs.append([np.asarray(hit), np.asarray(val), np.asarray(served)])
    rec["engine"].append({"batches": outs,
                          "table": np.asarray(jax.device_get(t))[:cfg.num_sets]})
for cap, placement in eval(sys.argv[4]):
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh, cap=cap, placement=placement)
    rec["client"].append(cases.drive_client(
        cl, cases.client_steps(seed, 2, faults=False),
        lambda c: np.asarray(jax.device_get(c.table))))
with open(out, "wb") as f:
    pickle.dump(rec, f)
"""

# the JAX child's cases: per-peer depths 3 and ceil(1.0 * 32 / 2) = 16 on
# slabs of 32 queries, and two bounded clients
JAX_ENGINE = [(3, True), (1.0, False)]
JAX_CLIENT = [(1.0, "split"), (0.5, "roundrobin")]


def _bounded_engine_cases(ndev):
    return [(cases.CFG, cap, "onepass",
             [(k, v, o, None, None, None) for k, v, o in
              cases.engine_batches(SEED, 3, 32 * ndev, mixed)])
            for cap, mixed in JAX_ENGINE]


def _process_cases(ndev):
    """(engine, stream, client) cases of a process mesh of ``ndev`` ranks:
    the JAX child's bounded engines and clients, then full-cap chain (with
    ``order``), cost and rounds engines, and the stream runner."""
    engine = _bounded_engine_cases(ndev)
    for mode, eng in (("chain", "onepass"), ("cost", "onepass"), ("mixed", "rounds")):
        kw = dict(cases.CFG, cost_planes=1 if mode == "cost" else 0)
        engine.append((kw, "full", eng, _engine_batches(mode, ndev, seed=ndev + len(mode))))
    rng = np.random.default_rng(ndev)
    keys = rng.integers(1, 400, (4 * Q, 1)).astype(np.int32)
    stream = [(cases.CFG, "full", Q, "onepass",
               (keys, keys + 3, rng.integers(0, 4, 4 * Q).astype(np.int32), None, None))]
    client = [(cap, placement, cases.client_steps(SEED, ndev, faults=False))
              for cap, placement in JAX_CLIENT + [("full", "load")]]
    return engine, stream, client


def _one_process(ndev, engine_cases, stream_cases, client_cases):
    mesh = make_cache_mesh(ndev, "cpu")
    return {"engine": [run_engine(mesh, *c) for c in engine_cases],
            "stream": [run_stream(mesh, *c) for c in stream_cases],
            "client": [run_client(mesh, *c) for c in client_cases],
            "faults": fault_calls(mesh)}


class _JaxChild:
    def __init__(self, path):
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(path), str(SEED), repr(JAX_ENGINE),
             repr(JAX_CLIENT)], cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._rec = None

    def record(self):
        if self._rec is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.path, "rb") as f:
                self._rec = pickle.load(f)
        return self._rec


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    child = _JaxChild(tmp_path_factory.mktemp("route") / "d2.pkl")
    yield child
    if child.proc.poll() is None:
        child.proc.kill()
        child.proc.communicate()


@pytest.fixture(scope="module")
def process_runs(jax_child):
    """Each D's gloo ranks (run at first use, while the JAX child runs) and
    the one-process engine's records of the same cases."""
    runs = {}

    def get(ndev):
        if ndev not in runs:
            engine, stream, client = _process_cases(ndev)
            ranks = run_on_ranks(route_rank, ndev, "gloo", "cpu",
                                 args=(engine, stream, client))
            runs[ndev] = ranks, _one_process(ndev, engine, stream, client)
        return runs[ndev]

    return get


# ---------------------------------------------------------------------------
# the route over the in-process mesh
# ---------------------------------------------------------------------------

BOUNDED = [(d, cap, mixed) for d in (2, 8) for cap in (1.0, 3, 0.5) for mixed in (False, True)]


@pytest.mark.parametrize("ndev,mode,engine", ENGINE_CASES)
def test_route_over_cache_mesh_equals_direct_engine(ndev, mode, engine):
    """Full cap, every engine case of ``test_torch_sharded.py``: the route
    (an ``all_to_all`` that is a transpose) and the direct engine give the
    same hit, value and served planes (chain mode: the evicted planes too)
    after every batch and the same table, cost plane included."""
    kw = dict(cases.CFG, cost_planes=1 if mode == "cost" else 0)
    batches = _engine_batches(mode, ndev, seed=ndev * 7 + len(mode))
    mesh = make_cache_mesh(ndev, "cpu")
    got = run_engine(mesh, kw, "full", engine, batches, routed=True)
    cases.assert_records_equal(got, run_engine(mesh, kw, "full", engine, batches))


@pytest.mark.parametrize("ndev,cap,mixed", BOUNDED)
def test_bounded_route_over_cache_mesh_equals_direct_engine(ndev, cap, mixed):
    """Bounded per-peer depths on ``cases.engine_batches``: the same rows
    shed, and the admitted rows' results and the table are the direct
    engine's; some rows shed."""
    batches = [(k, v, o, None, None, None)
               for k, v, o in cases.engine_batches(SEED + ndev, 3, 32 * ndev, mixed)]
    mesh = make_cache_mesh(ndev, "cpu")
    got = run_engine(mesh, cases.CFG, cap, "onepass", batches, routed=True)
    cases.assert_records_equal(got, run_engine(mesh, cases.CFG, cap, "onepass", batches))
    assert not all(b[2].all() for b in got["batches"])


@pytest.mark.parametrize("ndev,cap,placement", [(8, 1.0, "split"), (2, 0.5, "roundrobin"),
                                                (7, 2.0, "load")])
def test_client_through_the_route_equals_direct_client(monkeypatch, ndev, cap, placement):
    """``ShardedCacheClient`` over chain ticks with route failures, a
    degraded shard and a reshard, its engine the route: every result,
    counter, pressure, orphan list and table equal the direct client's."""
    steps = cases.client_steps(SEED, ndev, reshard_to=3)
    want = run_client(make_cache_mesh(ndev, "cpu"), cap, placement, steps)
    monkeypatch.setattr(sharded, "make_sharded_engine",
                        lambda cfg, mesh, axis="cache", cap=None, max_rounds=None,
                        engine="rounds", in_place=False: sharded.make_routed_engine(
                            cfg, mesh, axis, cap, max_rounds, engine, in_place))
    got = run_client(make_cache_mesh(ndev, "cpu"), cap, placement, steps)
    cases.assert_records_equal(got, want)


# ---------------------------------------------------------------------------
# one shard per process (gloo)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4])
def test_process_engine_matches_one_process_engine(process_runs, ndev):
    """The routed engine over D gloo ranks (each its rows and its slab):
    bounded (sheds), chain with ``order``, cost and rounds cases give the
    one-process engine's gathered planes and table."""
    ranks, want = process_runs(ndev)
    for got, w in zip(ranks[0]["engine"], want["engine"], strict=True):
        cases.assert_records_equal(got, w)


@pytest.mark.parametrize("ndev", [2, 4])
def test_process_stream_and_client_match_one_process(process_runs, ndev):
    """The stream runner (counts summed over ranks) and the client (the
    same placement on every rank, one gather of every slab's results) equal
    the one-process runner's and client's records."""
    ranks, want = process_runs(ndev)
    cases.assert_records_equal(ranks[0]["stream"], want["stream"])
    cases.assert_records_equal(ranks[0]["client"], want["client"])


@pytest.mark.parametrize("ndev", [2, 4])
def test_every_rank_holds_the_same_record_and_refuses_subgroup_work(process_runs, ndev):
    """Every rank gathers the same records; ``mark_degraded`` and a
    reshard to one rank (a subgroup of the world) give every rank the
    one-process client's orphans, table and state; a reshard past the
    world's size is refused with a ``ValueError``; every call exchanged."""
    ranks, want = process_runs(ndev)
    for r, rec in enumerate(ranks):
        assert rec["rank"] == r and rec["exchanges"] > 0
        assert "cannot spawn processes" in rec["refused"]
        for key in ("engine", "stream", "client", "faults"):
            cases.assert_records_equal(rec[key], ranks[0][key], f"rank {r} {key}")
    cases.assert_records_equal(ranks[0]["faults"], want["faults"])
    assert ranks[0]["faults"]["degrade"] and ranks[0]["faults"]["state"]["ndev"] == 1


def test_process_mesh_matches_jax_d2(process_runs, jax_child):
    """D = 2: the JAX sharded engine at per-peer depths below the slab and
    the JAX client (no faults) against the gloo ranks: served masks, hits,
    values, tables and every client record equal."""
    want = jax_child.record()
    ranks, _ = process_runs(2)
    got = ranks[0]
    for g, w in zip(got["engine"][:len(JAX_ENGINE)], want["engine"], strict=True):
        cases.assert_records_equal(g, w)
        assert not all(b[2].all() for b in w["batches"])     # rows shed
    cases.assert_records_equal(got["client"][:len(JAX_CLIENT)], want["client"])


def test_run_on_ranks_reraises_a_rank_failure():
    """Rank 1 raises while rank 0 waits for it at a barrier: the call
    raises with rank 1's traceback and leaves no rank running."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_on_ranks(fail_on_rank, 2, "gloo", "cpu", args=(1,), timeout=120)
    with pytest.raises(ValueError, match="one card per rank"):
        run_on_ranks(fail_on_rank, 2, "nccl", "cpu", args=(1,))


@pytest.mark.slow
def test_process_mesh_d8_matches_one_process():
    """D = 8 ranks: every case, as at D = 2 and 4."""
    engine, stream, client = _process_cases(8)
    ranks = run_on_ranks(route_rank, 8, "gloo", "cpu", args=(engine, stream, client))
    want = _one_process(8, engine, stream, client)
    for key in ("engine", "stream", "client", "faults"):
        cases.assert_records_equal(ranks[0][key], want[key], key)
