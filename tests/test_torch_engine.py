"""Engine parity: the port's one-pass and rounds engines against the JAX
package's, on random batches with ``valid`` masks and ``max_rounds`` caps,
on chain-op batches with chain ids and costs, and the engine helpers
(``group_offsets``, ``chain_exec_from_hits``).  (table, AccessResult,
served) must match field for field, bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import init_table as jax_init_table
from repro.core import engine as jax_engine
from repro.kernels.ops import onepass_update as jax_onepass_update
from repro_torch.core import (MSLRUConfig, OP_ACCESS, OP_CHAIN_GET,
                              OP_CHAIN_PUT, OP_DELETE, OP_GET, OP_LOOKUP,
                              init_table, table_from_numpy)
from repro_torch.core import engine
from repro_torch.kernels import msl_cache
from repro_torch.core.multistep import set_index_for
from repro_torch.kernels.ops import (kernel_rounds_update,
                                     make_kernel_batched_engine, onepass_update)


def assert_same(want, got, what=""):
    """Arrays (or NamedTuples / tuples of them) equal, numpy or JAX or torch."""
    if isinstance(want, tuple):
        names = getattr(want, "_fields", range(len(want)))
        for name, w, g in zip(names, want, got):
            assert_same(w, g, f"{what}.{name}")
        return
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=f"{what} mismatch")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


UPDATE_CFGS = [
    dict(num_sets=8, m=2, p=4, value_planes=2),
    dict(num_sets=4, m=1, p=4, value_planes=0),
    dict(num_sets=8, m=2, p=2, key_planes=2, value_planes=1, cost_planes=1),
]


def _random_update(kw, seed, b=192):
    rng = np.random.default_rng(seed)
    kp, v = kw.get("key_planes", 1), kw["value_planes"]
    keys = rng.integers(1, 60, (b, kp)).astype(np.int32)
    vals = rng.integers(-99, 99, (b, v)).astype(np.int32).reshape(b, v)
    valid = rng.random(b) < 0.75
    ops = rng.choice(np.array([OP_ACCESS, OP_GET, OP_DELETE, OP_LOOKUP],
                              np.int32), b)
    costs = rng.integers(0, 4, b).astype(np.int32)
    return keys, vals, valid, ops, costs


@pytest.mark.parametrize("max_rounds,with_ops", [(None, False), (None, True),
                                                  (1, True), (2, False), (4, True)])
@pytest.mark.parametrize("ci", range(len(UPDATE_CFGS)))
def test_update_parity_capped_and_masked(ci, max_rounds, with_ops):
    kw = UPDATE_CFGS[ci]
    keys, vals, valid, ops, costs = _random_update(kw, seed=ci * 10 + (max_rounds or 0))
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    jops = jnp.asarray(ops) if with_ops else None
    jcosts = jnp.asarray(costs) if kw.get("cost_planes") else None
    jargs = (jcfg, jax_init_table(jcfg),
             jax_engine.set_index_for(jcfg, jnp.asarray(keys)), jnp.asarray(valid),
             jnp.asarray(keys), jnp.asarray(vals), max_rounds)
    want_rounds = jax_engine.batched_rounds_update(*jargs, ops=jops, costs=jcosts)
    want_onepass = jax_onepass_update(*jargs, use_kernel=False, ops=jops,
                                      costs=jcosts)
    assert_same(want_rounds, want_onepass, "jax rounds vs onepass")

    top = None if jops is None else _t(ops)
    tcosts = None if jcosts is None else _t(costs)
    targs = (cfg, init_table(cfg, "cpu"), set_index_for(cfg, _t(keys)), _t(valid),
             _t(keys), _t(vals), max_rounds)
    for name, fn in [("rounds", engine.batched_rounds_update),
                     ("kernel_rounds", kernel_rounds_update),
                     ("onepass", onepass_update)]:
        assert_same(want_rounds, fn(*targs, ops=top, costs=tcosts), name)


def test_onepass_matches_jax_pallas_kernel():
    """The port against the Pallas one-pass kernel itself (interpret mode),
    with duplicate chains crossing its block boundaries."""
    kw = dict(num_sets=16, m=2, p=4, value_planes=1)
    rng = np.random.default_rng(3)
    b = 256
    keys = rng.integers(1, 200, (b, 1)).astype(np.int32)
    vals = rng.integers(-500, 500, (b, 1)).astype(np.int32)
    valid = rng.random(b) < 0.9
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    want = jax_onepass_update(jcfg, jax_init_table(jcfg),
                              jax_engine.set_index_for(jcfg, jnp.asarray(keys)),
                              jnp.asarray(valid), jnp.asarray(keys),
                              jnp.asarray(vals), use_kernel=True, block_b=64,
                              interpret=True)
    got = onepass_update(cfg, init_table(cfg, "cpu"), set_index_for(cfg, _t(keys)),
                         _t(valid), _t(keys), _t(vals))
    assert_same(want, got, "onepass")


def random_chain_batch(rng, kp, v, n_chains=6, max_len=5, key_range=40, b=64):
    """One batch of ``b`` queries honouring the chain contract: every
    chain's CHAIN_GET run, then every chain's CHAIN_PUT run (a prefix of its
    keys, same order), then plain ops.  Returns numpy (keys, vals, ops,
    chain_ids, costs)."""
    def key():
        k = [int(rng.integers(1, key_range))]
        return k + [int(rng.integers(0, 2))] * (kp - 1)

    chains = [[key() for _ in range(int(rng.integers(1, max_len + 1)))]
              for _ in range(n_chains)]
    rows = [(k, OP_CHAIN_GET, c) for c, ch in enumerate(chains) for k in ch]
    rows += [(k, OP_CHAIN_PUT, c) for c, ch in enumerate(chains)
             for k in ch[:int(rng.integers(0, len(ch) + 1))]]
    rows += [(key(), int(rng.choice([OP_ACCESS, OP_GET, OP_DELETE, OP_LOOKUP])), 0)
             for _ in range(b - len(rows))]
    keys = np.array([r[0] for r in rows], np.int32).reshape(b, kp)
    ops = np.array([r[1] for r in rows], np.int32)
    cids = np.array([r[2] for r in rows], np.int32)
    vals = rng.integers(-99, 99, (b, v)).astype(np.int32).reshape(b, v)
    costs = rng.integers(0, 4, b).astype(np.int32)
    return keys, vals, ops, cids, costs


CHAIN_CFGS = [
    dict(num_sets=4, m=2, p=4, value_planes=1),
    dict(num_sets=8, m=2, p=2, key_planes=2, value_planes=1, cost_planes=1),
    dict(num_sets=4, m=2, p=2, value_planes=0, cost_planes=1, policy="set_lru"),
]


@pytest.mark.parametrize("ci", range(len(CHAIN_CFGS)))
def test_chain_batches_match_jax(ci):
    """Chain-op batches with chain ids and costs through the one-pass,
    rounds and sequential engines of both packages, three batches deep."""
    kw = CHAIN_CFGS[ci]
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    kp, v = cfg.key_planes, cfg.value_planes
    rng = np.random.default_rng(100 + ci)
    has_cost = bool(cfg.cost_planes)
    jax_runs = {
        "onepass": jax_engine.make_batched_engine(jcfg, engine="onepass"),
        "rounds": jax_engine.make_batched_engine(jcfg, engine="rounds"),
        "seq": jax_engine.make_sequential_engine(jcfg, with_ops=True),
    }
    runs = {
        "onepass": engine.make_batched_engine(cfg, engine="onepass"),
        "rounds": engine.make_batched_engine(cfg, engine="rounds"),
        "kernel_rounds": make_kernel_batched_engine(cfg, engine="rounds"),
        "seq": engine.make_sequential_engine(cfg, with_ops=True),
    }
    jt = {n: jax_init_table(jcfg) for n in jax_runs}
    tt = {n: init_table(cfg, "cpu") for n in runs}
    for step in range(3):
        keys, vals, ops, cids, costs = random_chain_batch(rng, kp, v)
        jc = jnp.asarray(costs) if has_cost else None
        tc = _t(costs) if has_cost else None
        want = {}
        for n, run in jax_runs.items():
            jt[n], want[n] = run(jt[n], jnp.asarray(keys), jnp.asarray(vals),
                                 jnp.asarray(ops), jnp.asarray(cids), costs=jc)
        for n, run in runs.items():
            tt[n], got = run(tt[n], _t(keys), _t(vals), _t(ops), _t(cids), costs=tc)
            ref = want["seq" if n == "seq" else
                       "onepass" if n == "onepass" else "rounds"]
            assert_same(ref, got, f"batch {step} {n}")
            np.testing.assert_array_equal(tt[n].numpy(), np.asarray(jt["seq"]),
                                          err_msg=f"batch {step} {n} table")


@pytest.mark.parametrize("policy", ["set_lru", "multistep"])
def test_sequential_engine_plain_dispatch_matches_jax(policy, monkeypatch):
    """make_sequential_engine on CPU tensors runs ``msl_seq_plain`` (once a
    call, no kernel launch), bit-equal to JAX's jitted ``lax.scan`` engine
    over every opcode, chain ops with chain ids, a cost plane, two key
    planes and A = 32 (fig11's m = 8, p = 4), three streams deep."""
    kw = dict(num_sets=2, m=8, p=4, key_planes=2, value_planes=1, cost_planes=1,
              policy=policy)
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    calls = []
    plain = msl_cache.msl_seq_plain
    monkeypatch.setattr(msl_cache, "msl_seq_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    launches = msl_cache.LAUNCHES["msl_seq"]
    jrun = jax_engine.make_sequential_engine(jcfg, with_ops=True)
    run = engine.make_sequential_engine(cfg, with_ops=True)
    rng = np.random.default_rng(31)
    jt, tt = jax_init_table(jcfg), init_table(cfg, "cpu")
    evictions = 0
    for step in range(3):
        keys, vals, ops, cids, costs = random_chain_batch(rng, 2, 1, n_chains=10,
                                                          key_range=200, b=160)
        jt, want = jrun(jt, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(ops),
                        jnp.asarray(cids), costs=jnp.asarray(costs))
        tt, got = run(tt, _t(keys), _t(vals), _t(ops), _t(cids), costs=_t(costs))
        assert_same(want, got, f"stream {step}")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"stream {step} table")
        assert set(ops.tolist()) == {OP_ACCESS, OP_GET, OP_DELETE, OP_LOOKUP,
                                     OP_CHAIN_GET, OP_CHAIN_PUT}
        evictions += int(np.asarray(want.evicted_valid).sum())
    assert evictions > 0
    assert len(calls) == 3 and msl_cache.LAUNCHES["msl_seq"] == launches


def test_chain_live_from_a_jax_warmed_table():
    """chain_live_mask on a warmed table carried over from the JAX package."""
    kw = dict(num_sets=4, m=2, p=4, value_planes=1)
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    rng = np.random.default_rng(9)
    warm = rng.integers(1, 40, (24, 1)).astype(np.int32)
    jtable, _ = jax_engine.make_batched_engine(jcfg)(
        jax_init_table(jcfg), jnp.asarray(warm), jnp.asarray(warm))
    keys, _, ops, cids, _ = random_chain_batch(rng, 1, 1, n_chains=8)
    want = jax.jit(jax_engine.chain_live_mask, static_argnums=0)(jcfg, jtable, jnp.asarray(keys),
                                      jnp.asarray(ops), jnp.asarray(cids))
    got = engine.chain_live_mask(cfg, table_from_numpy(np.asarray(jtable), "cpu"),
                                 _t(keys), _t(ops), _t(cids))
    assert_same(want, got, "chain_live")
    assert np.asarray(want).any() and not np.asarray(want).all()


@pytest.mark.parametrize("seed", range(4))
def test_group_offsets_and_chain_exec_match_jax(seed):
    rng = np.random.default_rng(seed)
    b = 300
    ids = rng.integers(0, 17, b).astype(np.int32)
    assert_same(jax.jit(jax_engine.group_offsets)(jnp.asarray(ids)),
                engine.group_offsets(_t(ids)), "group_offsets")
    srt = np.sort(ids)
    assert_same(jax_engine.sorted_group_ranks(jnp.asarray(srt)),
                engine.sorted_group_ranks(_t(srt)), "sorted_group_ranks")

    ops = rng.choice(np.array([OP_ACCESS, OP_GET, OP_CHAIN_GET, OP_CHAIN_PUT],
                              np.int32), b, p=[0.1, 0.1, 0.5, 0.3])
    cids = np.repeat(rng.integers(0, b, b // 4), 4).astype(np.int32)
    raw_hit = rng.random(b) < 0.7
    for valid in (None, rng.random(b) < 0.9):
        want = jax.jit(jax_engine.chain_exec_from_hits)(
            jnp.asarray(ops), jnp.asarray(cids), jnp.asarray(raw_hit),
            None if valid is None else jnp.asarray(valid))
        got = engine.chain_exec_from_hits(_t(ops), _t(cids), _t(raw_hit),
                                          None if valid is None else _t(valid))
        assert_same(want, got, "chain_exec_from_hits")


def test_chunked_stream_runner_matches_jax():
    kw = dict(num_sets=16, m=2, p=4, value_planes=1)
    keys = np.random.default_rng(2).integers(1, 300, (1000, 1)).astype(np.int32)
    vals = keys * 7
    jcfg, cfg = JaxConfig(**kw), MSLRUConfig(**kw)
    jt, jhits = jax_engine.make_chunked_stream_runner(jcfg, 128, engine="onepass")(
        jax_init_table(jcfg), jnp.asarray(keys), jnp.asarray(vals))
    tt, hits = engine.make_chunked_stream_runner(cfg, 128, engine="onepass")(
        init_table(cfg, "cpu"), _t(keys), _t(vals))
    assert int(hits) == int(jhits)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
