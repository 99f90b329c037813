"""Sheds, retries, split placement, throttling and fault plans through the
port's prefix cache and serving engine, against the JAX package's, on the
CPU.

* The prefix cache's shed protocol (whole-chain sheds and retries, suffix
  sheds with their served boundary, boundary zero, the leading-hit-run
  hit length, sheds on the split path) through a backend that sheds chosen
  chains from chosen chunks on, wrapping each package's local cache: the
  port's results and stats equal JAX's on the same calls.
* Owner-aware admission throttling: the admission scan of both engines on
  the same queues and pressures.
* The whole engine behind ``ShardedCacheClient`` at D = 2: a JAX child (two
  fake CPU devices, started when this module's first test runs) serves
  phi3-mini-smoke under bounded caps, split placement, throttling and a
  handcrafted and a seeded ``FaultPlan``, in paged and contiguous,
  in-flight and megastep modes; the port serves the same requests on the
  same weights, and ticks, ``fault_log``, finish order, prefill split,
  every stats key, the pool and the backend's table are equal, the
  streams equal or split at a one-ulp tie.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import MSLRUConfig as JaxConfig
from repro.core import MultiStepLRUCache as JaxCache
from repro.core.multistep import AccessResult as JaxResult
from repro.models.model import make_model as jax_make_model
from repro.serving import engine as jengine
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.configs import get_config
from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, OP_CHAIN_GET,
                              OP_CHAIN_PUT, params_from_numpy)
from repro_torch.core.sharded import ShardedCacheClient
from repro_torch.launch import elastic, serve
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.models.model import make_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache, chunk_chain_hashes

import torch_sharded_cases as cases
from test_torch_serving import _assert_streams_equal_or_tied

ROOT = Path(__file__).resolve().parent.parent
ARCH = cases.ARCH

# ---------------------------------------------------------------------------
# the serving child (JAX engine behind a D = 2 ShardedCacheClient)
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path[:0] = ["src", "tests"]
import numpy as np, jax
from repro.configs import get_config
from repro.core import MSLRUConfig
from repro.core.sharded import ShardedCacheClient
from repro.launch.elastic import FaultEvent, FaultPlan
from repro.launch.mesh import make_cache_mesh
from repro.models.model import make_model
from repro.serving.engine import Request, ServeEngine
from repro.serving.kv_cache import PagedKVPool
from repro.serving.prefix_cache import PrefixCache
import torch_sharded_cases as t

cfg = get_config(t.ARCH, smoke=True)
model = make_model(cfg)
params = model.init(jax.random.PRNGKey(0))
cases = t.SLOW_SERVE_CASES if sys.argv[2] == "slow" else t.SERVE_CASES
rec = {}
for name, (eng_kw, be_kw, plan) in cases.items():
    be = ShardedCacheClient(MSLRUConfig(**t.BACKEND_CFG), make_cache_mesh(2), **be_kw)
    pc = PrefixCache(chunk_tokens=16, backend=be)
    pool = PagedKVPool(cfg, n_pages=t.N_PAGES, page_tokens=16)
    eng = ServeEngine(model, params, prefix_cache=pc, pool=pool, **t.ENGINE, **eng_kw)
    for i, p in enumerate(t.prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=t.MAX_NEW))
    eng.run_until_done(fault_plan=t.fault_plan(FaultEvent, FaultPlan, plan))
    rec[name] = t.summary(eng, np.asarray(jax.device_get(be.table)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(rec, f)
"""


class _Child:
    def __init__(self, path, which):
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(path), which], cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._rec = None

    def record(self):
        if self._rec is None:
            _, err = self.proc.communicate(timeout=1200)
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.path, "rb") as f:
                self._rec = pickle.load(f)
        return self._rec


@pytest.fixture(scope="module", autouse=True)
def serve_child(tmp_path_factory):
    """The fast lane's serving child, running while the in-process tests run."""
    child = _Child(tmp_path_factory.mktemp("shed") / "serve.pkl", "fast")
    yield child
    if child.proc.poll() is None:
        child.proc.kill()
        child.proc.communicate()


@pytest.fixture(scope="module")
def models():
    """The JAX smoke model and its parameters (PRNGKey(0), as in the child),
    carried into the port."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, jm, jp), (cfg, make_model(cfg), tp)


def _port_serve(stack, eng_kw, be_kw, plan):
    cfg, model, params = stack
    be = ShardedCacheClient(MSLRUConfig(**cases.BACKEND_CFG), make_cache_mesh(2, "cpu"), **be_kw)
    pc = PrefixCache(chunk_tokens=16, backend=be)
    pool = PagedKVPool(cfg, n_pages=cases.N_PAGES, page_tokens=16, device="cpu")
    eng = ServeEngine(model, params, prefix_cache=pc, pool=pool, **cases.ENGINE, **eng_kw)
    for i, p in enumerate(cases.prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=cases.MAX_NEW))
    eng.run_until_done(fault_plan=cases.fault_plan(elastic.FaultEvent, elastic.FaultPlan, plan))
    return eng, cases.summary(eng, be.table.cpu().numpy())


def _check_serve(models, want, case):
    (jcfg, jm, jp), stack = models
    eng, got = _port_serve(stack, *case)
    ps = cases.prompts(jcfg)
    # every request served in full, the pool balanced, nothing pending
    assert len(eng.finished) == len(ps)
    refcount, free, reserved = got["rest"]["pool"]
    assert free + sum(refcount) == cases.N_PAGES and reserved == 0
    assert got["rest"]["pending"] == 0
    jstats = want["rest"]["stats"]
    assert {k: got["rest"]["stats"][k] for k in jstats} == jstats
    jcache = want["rest"]["cache"]
    assert {k: got["rest"]["cache"][k] for k in jcache} == jcache
    assert {k: v for k, v in got["rest"].items() if k not in ("stats", "cache")} == \
        {k: v for k, v in want["rest"].items() if k not in ("stats", "cache")}
    _assert_streams_equal_or_tied(jm, jp, ps, got["tokens"], want["tokens"])
    return got


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_sharded_on_the_cpu(capsys):
    """``--sharded 8 --cap 1 --placement split --throttle-threshold 0.75
    --chaos-seed 0`` serves the launcher workload to completion (at cap 1
    no chunk fits a per-peer buffer: every chain sheds until it falls back,
    as in the JAX launcher); ``--sharded 8`` at full cap gives the local
    backend's tokens and prefill skips; the flag checks match JAX's, and a
    seeded plan that degrades a shard the mesh no longer has is refused
    before the serve."""
    base = ["--device", "cpu", "--kv-mode", "paged", "--requests", "12"]
    serve.main(base + ["--sharded", "8", "--cap", "1", "--placement", "split",
                       "--throttle-threshold", "0.75", "--chaos-seed", "0"])
    out = capsys.readouterr().out
    assert "12 requests in" in out and "faults applied: [(" in out
    assert "[serve] sharded: D=8 placement=split" in out
    local = serve.build(serve.parser().parse_args(base))
    sharded = serve.build(serve.parser().parse_args(base + ["--sharded", "8"]))
    args = serve.parser().parse_args(base)
    for eng in (local, sharded):
        for r in serve.make_requests(eng.cfg, args):
            eng.submit(r)
        eng.run_until_done()
    assert ({r.rid: (r.out_tokens, r.prefill_skipped) for r in local.finished}
            == {r.rid: (r.out_tokens, r.prefill_skipped) for r in sharded.finished})
    assert local.ticks == sharded.ticks
    # seed 1 at D = 8 over 24 ticks resizes to 1 shard, then degrades shard 6
    for bad, msg in ((["--throttle-threshold", "0.5"], "needs --sharded"),
                     (["--chaos-seed", "1"], "needs --sharded"),
                     (["--requests", "24", "--sharded", "8", "--chaos-seed", "1"],
                      "degrades shard 6 at tick 12 on a mesh of 1 shards")):
        with pytest.raises(ValueError, match=msg):
            serve.build(serve.parser().parse_args(base + bad))
    assert serve.fault_plan(serve.parser().parse_args(base)) is None


# ---------------------------------------------------------------------------
# the prefix cache's shed protocol, against JAX's
# ---------------------------------------------------------------------------

class _ShedBackend:
    """A local cache (either package's) that sheds, on its first
    ``shed_calls`` chain calls, each listed chain's rows from chunk
    ``boundaries[cid]`` on in both islands (0: the whole chain), the way
    ``ShardedCacheClient`` sheds; with ``shed_all`` it sheds every row of
    those calls (a split-path shed).  Shed rows never reach the cache."""

    batch_multiple = 1
    self_padding = True

    def __init__(self, port, boundaries, shed_calls=1, shed_all_calls=0):
        kw = dict(num_sets=16, m=2, p=2, value_planes=1)
        self.port = port
        self.cfg = MSLRUConfig(**kw) if port else JaxConfig(**kw)
        self.inner = MultiStepLRUCache(self.cfg, device="cpu") if port else JaxCache(self.cfg)
        self.boundaries = dict(boundaries)
        self.shed_calls, self.shed_all_calls = shed_calls, shed_all_calls
        self.chain_calls = self.calls = 0
        self.last_shed = None

    def access(self, keys, vals=None, ops=None, chain_ids=None, costs=None):
        keys = np.asarray(keys, np.int32).reshape(-1)
        n = keys.shape[0]
        shed = np.zeros(n, bool)
        if self.calls < self.shed_all_calls:
            shed[:] = True
        if chain_ids is not None:
            if self.chain_calls < self.shed_calls:
                ops_a, cid = np.asarray(ops), np.asarray(chain_ids)
                seen: dict = {}
                for i in range(n):
                    b = self.boundaries.get(int(cid[i]))
                    if b is None or ops_a[i] not in (OP_CHAIN_GET, OP_CHAIN_PUT):
                        continue
                    t = seen.get((int(cid[i]), int(ops_a[i])), 0)
                    seen[(int(cid[i]), int(ops_a[i]))] = t + 1
                    shed[i] |= t >= b
            self.chain_calls += 1
        self.calls += 1
        self.last_shed = shed
        keep = ~shed
        v = self.cfg.value_planes
        out = {"hit": np.zeros(n, bool), "value": np.zeros((n, v), np.int32),
               "pos": np.full(n, -1, np.int32),
               "evicted_key": np.zeros((n, 1), np.int32),
               "evicted_val": np.zeros((n, v), np.int32),
               "evicted_valid": np.zeros(n, bool)}
        if keep.any():
            sub = self.inner.access(
                keys[keep], None if vals is None else np.asarray(vals)[keep],
                ops=None if ops is None else np.asarray(ops)[keep],
                chain_ids=None if chain_ids is None else np.asarray(chain_ids)[keep])
            for f in out:
                x = getattr(sub, f)
                out[f][keep] = x.cpu().numpy() if self.port else np.asarray(x)
        return JaxResult(**out)

    @property
    def occupancy(self):
        return self.inner.occupancy


def _chain_serves(results):
    return [(r.pages, r.hitlen, r.puts, r.shed, r.served_len) for r in results]


def _scenario(port, name):
    """Drive one shed scenario through a ``PrefixCache`` of either package;
    returns what it reports."""
    pc_cls = PrefixCache if port else JaxPrefixCache
    chains = [[11, 13, 15], [21, 23, 25]]
    out = []
    if name == "whole_shed_retry":
        pc = pc_cls(chunk_tokens=8, backend=_ShedBackend(port, {1: 0}))
        out.append(pc.serve_chains(chains, [[1, 2, 3], [4, 5, 6]]))
        out.append(pc.serve_chains([chains[1]], [[4, 5, 6]], retries=[True]))
        out.append(pc.serve_chains(chains, [[], []]))
    elif name == "suffix_shed":
        pc = pc_cls(chunk_tokens=8, backend=_ShedBackend(port, {1: 2}))
        out.append(pc.serve_chains(chains, [[1, 2, 3], [4, 5, 6]]))
        out.append(pc.insert_chains([chains[1][2:]], [[6]], depths=[2], chain_lens=[3]))
        out.append(pc.serve_chains([chains[1]], [[]]))
    elif name == "boundary_zero":
        pc = pc_cls(chunk_tokens=8, backend=_ShedBackend(port, {0: 0}))
        out.append(pc.serve_chains([[11, 13]], [[1, 2]]))
    elif name == "hitlen_leading_run":
        be = _ShedBackend(port, {}, shed_calls=0)
        pc_cls(chunk_tokens=8, backend=be).insert_chains([[11], [15]], [[1], [3]],
                                                        depths=[0, 2], chain_lens=[3, 3])
        pc = pc_cls(chunk_tokens=8, backend=be)
        out.append(pc.serve_chains([[11, 13, 15]], [[4, 5, 6]]))
    elif name == "split_path_sheds":
        pc = pc_cls(chunk_tokens=8, backend=_ShedBackend(port, {}, shed_all_calls=1))
        out.append(pc.insert_chains(chains, [[1, 2, 3], [4, 5, 6]]))
        out.append(pc.insert_chains(chains, [[1, 2, 3], [4, 5, 6]]))
        pc.cache.shed_all_calls = 4      # the lookup's probe and one delete shed
        out.append(pc.lookup_chains(chains))
        out.append((pc.delete(13), pc.delete(25)))
        out.append(pc.lookup_chains(chains))
    for i, o in enumerate(out):
        if isinstance(o, tuple) and len(o) == 2 and isinstance(o[0], list) \
                and o[0] and hasattr(o[0][0], "hitlen"):
            out[i] = (_chain_serves(o[0]), o[1])
    st = pc.stats()
    return out, {k: st[k] for k in ("hits", "misses", "evictions", "shed",
                                    "partial_served", "retried", "fallbacks", "occupancy")}


@pytest.mark.parametrize("name", ["whole_shed_retry", "suffix_shed", "boundary_zero",
                                  "hitlen_leading_run", "split_path_sheds"])
def test_prefix_cache_shed_protocol_matches_jax(name):
    """Each shed scenario gives the JAX package's ``ChainServe`` results,
    recycled pages and stats.  Whole sheds serve nothing and count nothing
    until retried; a suffix shed serves the prefix up to its boundary
    (``partial_served``) and the tail inserts afterwards; boundary 0 is a
    whole shed; hit length is the leading hit run of the served prefix; on
    the split path a shed probe is a forced miss and a shed insert returns
    its staged page."""
    got, want = _scenario(True, name), _scenario(False, name)
    assert got == want
    res, st = got
    if name == "whole_shed_retry":
        first = res[0][0]
        assert not first[0][3] and first[1][3] and first[1][4] == 0
        assert st["shed"] == 1 and st["retried"] == 1
        assert [r[1] for r in res[2][0]] == [3, 3]
    elif name == "suffix_shed":
        assert res[0][0][1][4] == 2 and res[0][0][1][2][2] is None
        assert st["partial_served"] == 1 and st["shed"] == 0
        assert res[2][0][0][1] == 3 and res[2][0][0][0] == [4, 5, 6]
    elif name == "boundary_zero":
        assert res[0][0][0][3] and st["partial_served"] == 0 and st["shed"] == 1
    elif name == "hitlen_leading_run":
        assert res[0][0][0][1] == 1 and res[0][0][0][0] == [1]
    else:
        assert sorted(res[0]) == [1, 2, 3, 4, 5, 6]   # shed inserts return pages
        assert res[3] == (False, True) and st["shed"] > 0


# ---------------------------------------------------------------------------
# owner-aware admission throttling, against JAX's scan
# ---------------------------------------------------------------------------

class _Pressure:
    """Chains whose first chunk hash is in ``hot`` report saturated shards."""

    def __init__(self, hot):
        self.hot = set(hot)

    def chain_pressure(self, chain) -> float:
        return 1.0 if chain and chain[0] in self.hot else 0.0


class _FakePC:
    def __init__(self, backend):
        self.cache = backend
        self.chunk_tokens = 4


def _first_hash(prompt):
    return chunk_chain_hashes(np.asarray(prompt, np.int32), 4)[:1]


THROTTLE_CASES = {
    # (hot prompts, queue [(prompt, force_plain, throttle_ticks)], threshold)
    "cool_jumps_ahead": ([[1] * 8], [([1] * 8, False, 0), ([5] * 8, False, 0)], 0.8),
    "all_hot_admits_front": ([[1] * 8, [2] * 8], [([1] * 8, False, 0), ([2] * 8, False, 0)], 0.8),
    "fallback_exempt": ([[1] * 8], [([1] * 8, True, 0), ([5] * 8, False, 0)], 0.8),
    "starved_exempt": ([[1] * 8], [([1] * 8, False, 8), ([5] * 8, False, 0)], 0.8),
    "off_is_fifo": ([[1] * 8], [([1] * 8, False, 0), ([5] * 8, False, 0)], None),
    "short_prompt": ([], [([1, 2], False, 0), ([5] * 8, False, 0)], 0.8),
}


def _throttle(port, case):
    hot, queue, thr = case
    eng_cls, req_cls = (ServeEngine, Request) if port else (jengine.ServeEngine, jengine.Request)
    eng = eng_cls.__new__(eng_cls)
    eng.queue = [req_cls(rid=i, prompt=np.asarray(p, np.int32), force_plain=fp,
                         throttle_ticks=tt) for i, (p, fp, tt) in enumerate(queue)]
    backend = _Pressure(h for p in hot for h in _first_hash(p))
    eng.prefix_cache = _FakePC(backend)
    eng.use_prefix = True
    eng.throttle_threshold = thr
    eng.max_throttle_ticks = 8
    eng.throttled_admissions = 0
    picks = [eng._pop_admission().rid]
    backend.hot.clear()
    picks.append(eng._pop_admission().rid)
    return picks, eng.throttled_admissions


@pytest.mark.parametrize("name", list(THROTTLE_CASES))
def test_throttle_scan_matches_jax(name):
    """The admission scan picks the same requests as JAX's: a cool request
    jumps a hot one (which admits once the pressure clears), an all-hot
    queue admits its front, fallbacks, starved requests and prompts below a
    chunk are never held back, and throttling off is FIFO."""
    got = _throttle(True, THROTTLE_CASES[name])
    assert got == _throttle(False, THROTTLE_CASES[name])
    assert got == (([1, 0], 1) if name == "cool_jumps_ahead" else ([0, 1], 0))


def test_shed_chain_retries_instead_of_raising(models):
    """A shed chain releases its slot and staged pages and retries next tick
    (it used to raise); a chain shed on every call falls back to plain
    prefill after ``max_shed_retries`` and still completes."""
    _, (cfg, model, params) = models
    pool = PagedKVPool(cfg, n_pages=8, page_tokens=16, device="cpu")
    be = _ShedBackend(True, {0: 0}, shed_calls=99)
    be.cfg = MSLRUConfig(num_sets=8, m=2, p=4, value_planes=1)
    be.inner = MultiStepLRUCache(be.cfg, device="cpu")
    pc = PrefixCache(chunk_tokens=16, backend=be)
    eng = ServeEngine(model, params, slots=1, max_len=64, prefix_cache=pc, pool=pool)
    eng.submit(Request(rid=0, prompt=np.ones(20, np.int32), max_new_tokens=2))
    eng.step()
    assert [r.rid for r in eng.retry_queue] == [0] and eng._free_slots == [0]
    assert pool.free_pages == 8 and not pool._reserved
    eng.run_until_done()
    st = eng.stats()
    assert [r.rid for r in eng.finished] == [0] and st["fallbacks"] == 1
    assert st["fallback_rate"] == 1.0 and pc.stats()["shed"] == 3
    assert eng.finished[0].service_ticks == 3


# ---------------------------------------------------------------------------
# against the serving child (last, so the tests above run while it serves)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(cases.SERVE_CASES))
def test_sharded_serve_matches_jax(models, serve_child, monkeypatch, name):
    """The engine behind a bounded D = 2 client under a fault plan against
    the JAX engine, paged in-flight under a handcrafted plan and contiguous
    megastep under a seeded one: sheds, retries, split chains, fallbacks
    and the faults themselves all happen, and ticks, ``fault_log``, finish
    order, prefill split, every stats key (the seven shed/split/throttle
    keys among them), pool and table equal JAX's.  In-flight, admissions
    are throttled and a chain is partly served; megastep, a fault's tick
    caps at least one window below what ``_plan_window`` plans without
    it."""
    plans = []
    plan_window = ServeEngine._plan_window

    def recording(self, cap=None):
        k = plan_window(self, cap)
        plans.append((k, plan_window(self, None)))
        return k

    monkeypatch.setattr(ServeEngine, "_plan_window", recording)
    got = _check_serve(models, serve_child.record()[name], cases.SERVE_CASES[name])
    st, cache = got["rest"]["stats"], got["rest"]["cache"]
    assert len(got["rest"]["fault_log"]) == 3
    assert cache["shed"] + st["partial_sheds"] > 0 and cache["retried"] > 0
    assert st["split_chains"] > 0 and st["slab_occupancy_peak"] > 0
    assert st["fallbacks"] > 0 and cache["hits"] > 0
    if st["megastep_windows"]:
        assert any(k < free for k, free in plans)
    else:
        assert st["throttled_admissions"] > 0 and st["partial_served"] > 0


@pytest.mark.slow
def test_sharded_serve_matches_jax_more_modes(models, tmp_path):
    """As ``test_sharded_serve_matches_jax``: full cap megastep, whole-chain
    load placement under a shard loss and a resize, round-robin decode with
    round-robin placement, throttling and a seeded plan, and split
    admission (where sheds are forced misses)."""
    want = _Child(tmp_path / "slow.pkl", "slow").record()
    for name, case in cases.SLOW_SERVE_CASES.items():
        _check_serve(models, want[name], case)
