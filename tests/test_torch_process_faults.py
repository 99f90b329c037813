"""Faults across processes: the sharded cache's ``mark_degraded`` and
``reshard`` with one shard per gloo rank on the CPU, and the prefix-cached
serve with its cache on those ranks, against the JAX package.

* Resharding under eviction pressure (``tests/test_reshard.py``'s workload,
  seeds 0-2): D -> D' for (2, 1), (2, 4) and (4, 3), each in a world of
  max(D, D') ranks, (8, 4), (4, 8) and (8, 7) in one world of 8 under
  ``-m slow``.  At
  full cap the client's results and table do not depend on D, so the
  reference is the JAX client on its one CPU device, in this process: on
  every rank the rebuilt table, the orphans and the drain stream equal
  its, ``ndev`` and ``s_local`` are D''s, the table equals a cold port
  engine fed the drain stream, every re-inserted chain is resident, and
  every rank holds the same client state.  A reshard past the world's size
  raises ``ValueError``.
* The client under route failures, a lost shard and a reshard
  (``cases.client_steps(faults=True)``): at D = 2 and 4 every rank gives
  the one-process client's record, SPMD and with rank 0 leading while the
  others follow; at D = 2 the record equals a JAX child's with two fake
  devices.
* Both ``cases.SERVE_CASES`` with the cache on 2 gloo ranks and the engine
  on rank 0 against the JAX serving child (``test_torch_shed_retry.py``'s):
  ticks, ``fault_log``, finish order, prefill split, every stats key, pool
  and table equal, the streams equal or split at a one-ulp tie.
* The launcher's ``--processes`` gives the one-process launch's ticks,
  fault log, finish order, prefill split and counters.
* Ranks that return at different times all exit with 0, and none takes a
  process group's native threads into interpreter exit.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_sharded_cases as cases
from repro.configs import get_config as jax_get_config
from repro.core import MSLRUConfig as JaxConfig
from repro.core.sharded import ShardedCacheClient as JaxClient
from repro.launch.mesh import make_cache_mesh as jax_cache_mesh
from repro.models.model import make_model as jax_make_model
from repro_torch.core import MSLRUConfig, MultiStepLRUCache
from repro_torch.core.sharded import sets_per_shard
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_cache_mesh, run_on_ranks
from test_torch_serving import _assert_streams_equal_or_tied
from test_torch_shed_retry import _Child
from torch_rank_fns import (faults_rank, reshard_rank, run_client, serve_case_rank,
                            staggered_rank)

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 2)
PAIRS = [(2, 1), (2, 4), (4, 3)]
SLOW_PAIRS = [(8, 4), (4, 8), (8, 7)]
FAULT_CLIENTS = [(1.0, "split"), (0.5, "roundrobin"), ("full", "load")]

_CLIENT_CHILD = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path[:0] = ["src", "tests"]
import numpy as np, jax
from repro.core import MSLRUConfig
from repro.core.sharded import ShardedCacheClient
from repro.launch.mesh import make_cache_mesh
import torch_sharded_cases as cases

rec = []
for cap, placement, steps in eval(sys.argv[2]):
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), make_cache_mesh(2), cap=cap,
                            placement=placement)
    rec.append(cases.drive_client(cl, steps, lambda c: np.asarray(jax.device_get(c.table))))
with open(sys.argv[1], "wb") as f:
    pickle.dump(rec, f)
"""


def _client_cases(ndev):
    return [(cap, placement, cases.client_steps(7, ndev, reshard_to=1 if ndev == 2 else 3))
            for cap, placement in FAULT_CLIENTS]


class _ClientChild:
    """The JAX client on 2 fake devices through the D = 2 fault steps."""

    def __init__(self, path):
        self.path = path
        steps = repr([(cap, pl, "STEPS") for cap, pl in FAULT_CLIENTS]).replace(
            "'STEPS'", "cases.client_steps(7, 2, reshard_to=1)")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CLIENT_CHILD, str(path), steps], cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
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
def children(tmp_path_factory):
    """The JAX serving child and the JAX client child, started at once and
    left to run while the tests before them run."""
    tmp = tmp_path_factory.mktemp("process_faults")
    kids = {"serve": _Child(tmp / "serve.pkl", "fast"),
            "client": _ClientChild(tmp / "client.pkl")}
    yield kids
    for k in kids.values():
        if k.proc.poll() is None:
            k.proc.kill()
            k.proc.communicate()


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(max_workers=3) as ex:
        yield ex


def _jax_reshard(seed):
    """The JAX client on its one CPU device through the reshard workload,
    resharding 1 -> 1."""
    cl = JaxClient(JaxConfig(**cases.RESHARD_CFG), jax_cache_mesh(1))
    return cases.drive_reshard(cl, seed, 1, lambda c: np.asarray(jax.device_get(c.table)))


@pytest.fixture(scope="module")
def reshards(children, pool):
    """A gloo world of max(D, D') ranks for each of ``PAIRS`` (all running
    in threads while the JAX references run here) and the JAX records per
    seed."""
    worlds = {pair: pool.submit(run_on_ranks, reshard_rank, max(pair), "gloo", "cpu",
                                args=([pair], SEEDS)) for pair in PAIRS}
    want = {seed: _jax_reshard(seed) for seed in SEEDS}
    return {pair: w.result() for pair, w in worlds.items()}, want


def _check_reshard(ranks, want, pairs):
    cfg = MSLRUConfig(**cases.RESHARD_CFG)
    for d, dp in pairs:
        for seed in SEEDS:
            w = want[seed]
            for r, rec in enumerate(ranks[(d, dp)]):
                got = rec[(d, dp, seed)]
                where = f"D={d}->{dp} seed {seed} rank {r}"
                for key in ("table", "orphans", "drain", "occ_before", "occ_after"):
                    cases.assert_records_equal(got[key], w[key], f"{where} {key}")
                assert got["ndev"] == dp and got["s_local"] == sets_per_shard(64, dp), where
                assert got["mesh_rank"] == (r if r < dp else -1), where
                assert got["resident"] and w["resident"], where
                cases.assert_records_equal(got["state"],
                                           ranks[(d, dp)][0][(d, dp, seed)]["state"], where)
            # pressure built up, and the rebuilt table is a cold engine's
            assert w["occ_before"] > 0.5 and w["drain"]
            oracle = MultiStepLRUCache(cfg, engine="onepass", device="cpu")
            for b in w["drain"]:
                oracle.access(b["keys"], b["vals"], ops=b["ops"], chain_ids=b["chain_ids"])
            assert np.array_equal(oracle.table.numpy(), ranks[(d, dp)][0][(d, dp, seed)]["table"])


@pytest.mark.parametrize("pair", PAIRS)
def test_reshard_across_processes_matches_jax(reshards, pair):
    """D -> D' over gloo ranks (shrink, grow, uneven): every rank's rebuilt
    table, orphans and drain stream equal the JAX client's; the table is
    a cold port engine's fed the drain stream; every chain re-inserted is
    resident; ranks past D' are outside the new group and agree all the
    same."""
    ranks, want = reshards
    _check_reshard(ranks, want, [pair])


def test_reshard_past_the_world_is_refused(reshards):
    """A running cache cannot spawn processes: a reshard to more shards
    than the world has ranks raises ``ValueError`` on every rank."""
    ranks, _ = reshards
    assert all("cannot spawn processes" in rec["refused"] for w in ranks.values() for rec in w)


@pytest.mark.slow
def test_reshard_across_eight_processes_matches_jax():
    """(8, 4), (4, 8) and (8, 7) in a world of 8 gloo ranks, as the fast
    pairs."""
    ranks = run_on_ranks(reshard_rank, 8, "gloo", "cpu", args=(SLOW_PAIRS, SEEDS))
    _check_reshard({pair: ranks for pair in SLOW_PAIRS},
                   {seed: _jax_reshard(seed) for seed in SEEDS}, SLOW_PAIRS)


@pytest.mark.parametrize("ndev", [2, 4])
def test_client_faults_across_processes(children, pool, ndev):
    """Route failures, a lost shard and a reshard (at D = 4 to 3: rank 3
    leaves the group and goes on replaying): every rank, SPMD and with rank
    0 leading, gives the one-process client's record and ends with its
    state; at D = 2 the record is the JAX child's."""
    client_cases = _client_cases(ndev)
    lead = pool.submit(run_on_ranks, faults_rank, ndev, "gloo", "cpu",
                       args=(client_cases, True))
    spmd = run_on_ranks(faults_rank, ndev, "gloo", "cpu", args=(client_cases,))
    led = lead.result()
    mesh = make_cache_mesh(ndev, "cpu")
    for i, (cap, placement, steps) in enumerate(client_cases):
        want = run_client(mesh, cap, placement, steps)
        assert sum("degrade" in s or "reshard" in s for s in want["steps"]) == 2
        for r in range(ndev):
            cases.assert_records_equal(spmd[r][i]["record"], want, f"spmd rank {r} case {i}")
            cases.assert_records_equal(spmd[r][i]["state"], spmd[0][i]["state"])
            cases.assert_records_equal(led[r][i]["state"], spmd[0][i]["state"],
                                       f"led rank {r} case {i}")
        cases.assert_records_equal(led[0][i]["record"], want, f"led case {i}")
        assert all(led[r][i]["calls"] > 0 for r in range(1, ndev))
        assert spmd[0][i]["state"]["ndev"] == (1 if ndev == 2 else 3)
    if ndev == 2:
        cases.assert_records_equal([c["record"] for c in spmd[0]],
                                   children["client"].record())


@pytest.fixture(scope="module")
def jax_models():
    jcfg = jax_get_config(cases.ARCH, smoke=True)
    jm = jax_make_model(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(cases.SERVE_CASES))
def test_serve_with_cache_across_processes_matches_jax(children, jax_models, name):
    """The engine on rank 0, its cache on 2 gloo ranks, under each case's
    fault plan: ticks, ``fault_log``, finish order, prefill split, every
    stats key, the pool and the table equal the JAX child's, the streams
    equal or split at a one-ulp tie; rank 1 replayed every cache call and
    ends with rank 0's client state."""
    jcfg, jm, jp = jax_models
    params_np = jax.tree.map(np.asarray, jp)
    ranks = run_on_ranks(serve_case_rank, 2, "gloo", "cpu",
                         args=(cases.SERVE_CASES[name], params_np))
    got = ranks[0]["summary"]
    want = children["serve"].record()[name]
    refcount, free, reserved = got["rest"]["pool"]
    assert got["rest"].pop("finished") == 10
    assert free + sum(refcount) == cases.N_PAGES and reserved == 0
    assert got["rest"]["pending"] == 0
    for key in ("stats", "cache"):
        assert {k: got["rest"][key][k] for k in want["rest"][key]} == want["rest"][key]
    assert {k: v for k, v in got["rest"].items() if k not in ("stats", "cache")} == \
        {k: v for k, v in want["rest"].items() if k not in ("stats", "cache")}
    assert len(got["rest"]["fault_log"]) == 3
    _assert_streams_equal_or_tied(jm, jp, cases.prompts(jcfg), got["tokens"], want["tokens"])
    assert ranks[1]["calls"] > 0
    cases.assert_records_equal(ranks[1]["state"], ranks[0]["state"])


# the native threads of a gloo group and of its store
GROUP_THREADS = {"gloo_tcp_loop", "pt_gloo_runloop", "pt_tcpstore_uv"}


@pytest.mark.parametrize("delays", [(0.0, 0.5), (0.5, 0.0), (0.4, 0.0, 0.2)],
                         ids=["rank1_late", "rank0_late", "three_ranks"])
def test_ranks_returning_apart_exit_cleanly(tmp_path, delays):
    """Ranks that return at different times after collectives over a cached
    world group: ``run_on_ranks`` returns (so every rank exited with 0
    after its result), and no rank still has a gloo or store thread when
    its interpreter exits (such threads, torn down at exit in no set
    order, aborted a rank now and then)."""
    world = len(delays)
    got = run_on_ranks(staggered_rank, world, "gloo", "cpu", args=(delays, str(tmp_path)))
    assert got == [[("call", i) for i in range(3)]] * world
    for r in range(world):
        names = set((tmp_path / f"rank{r}.txt").read_text().split())
        assert names and not names & GROUP_THREADS, (r, names)


LAUNCH = ["--device", "cpu", "--kv-mode", "paged", "--requests", "12", "--cap", "2",
          "--placement", "split", "--throttle-threshold", "0.75"]


@pytest.mark.parametrize("extra", [("--sharded", "2", "--chaos-seed", "0"),
                                   ("--sharded", "3", "--chaos-seed", "7")])
def test_launcher_processes_equal_one_process(capsys, extra):
    """``--processes`` (the shards in spawned gloo ranks) gives the
    one-process launch's ticks, fault log, finish order, prefill split and
    every counter; seed 7 at D = 3 shrinks the cache to 2 ranks and grows
    it back before losing shard 0.  The report adds the staging and gloo
    ms per exchange."""
    want = serve.main(LAUNCH + list(extra))
    capsys.readouterr()
    got = serve.main(LAUNCH + list(extra) + ["--processes"])
    out = capsys.readouterr().out
    ranks = got.pop("ranks")
    assert got == want
    assert len(want["fault_log"]) == 3 and want["prefix_cache"]["shed"] > 0
    assert "12 requests in" in out and "ms gloo per exchange" in out
    assert [r["rank"] for r in ranks] == list(range(len(ranks)))
    assert all(r["exchanges"] > 0 for r in ranks) and all(r["calls"] for r in ranks[1:])
    with pytest.raises(ValueError, match="--processes needs --sharded"):
        serve.main(["--device", "cpu", "--processes"])
