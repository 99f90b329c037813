"""The port's serving stack against the JAX package's, on the CPU.

Chunk hashing, the prefix cache's one-call serving tick, the paged KV pool's
page protocol and the whole ``ServeEngine`` on the paged-decode trace of
``tests/test_paged_decode.py``, each against its JAX counterpart on the same
inputs (integer state bit-equal; tokens equal on shared parameters), and
the port's paged engine against its own contiguous one (tokens
bit-identical, as in the JAX package).  The attention-decoder families and
the launcher are in ``test_torch_serving_families.py``; other test files
import this file's engine helpers (``_drive``, ``_prompts``, ``_summary``,
``_assert_streams_equal_or_tied``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro.serving import engine as jengine
from repro.serving.kv_cache import PagedKVPool as JaxPool
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serving.prefix_cache import chunk_chain_hashes as jax_chunk_chain_hashes
from repro.serving.prefix_cache import service_tick_percentiles as jax_percentiles
from repro_torch.configs import get_config
from repro_torch.core import params_from_numpy
from repro_torch.models.model import make_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import (ChainServe, PrefixCache,
                                              chunk_chain_hashes,
                                              service_tick_percentiles)

ARCH = "phi3-mini-3.8b"
CACHE_STATS = ("hits", "misses", "hit_ratio", "evictions", "occupancy",
               "service_ticks_p50", "service_ticks_p99", "reprefill_flops",
               "evicted_cost")
ENGINE_STATS = ("ticks", "decode_launches", "decode_tokens", "launch_rows",
                "megastep_windows", "mean_window",
                "host_syncs", "drain_launch_rows", "drain_decode_tokens",
                "requests_serviced", "service_ticks_p50", "service_ticks_p99",
                "pool_exhausted", "gather_calls", "resident_kv_tokens_peak",
                "resident_kv_tokens_mean", "resident_kv_bytes_peak",
                "reprefill_flops", "evicted_cost")


# ---------------------------------------------------------------------------
# chunk hashing and the prefix cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_chunk_chain_hashes_match_jax(chunk):
    rng = np.random.default_rng(chunk)
    for n in (0, chunk - 1, chunk, 5 * chunk + 3):
        toks = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
        assert chunk_chain_hashes(toks, chunk) == jax_chunk_chain_hashes(toks, chunk)


def test_service_tick_percentiles_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 100):
        s = rng.integers(0, 50, n)
        assert service_tick_percentiles(s) == jax_percentiles(s)


def _tick_chains(rng, n_templates=5, ticks=6, per_tick=5):
    """Per tick: chains of chunk hashes that share template prefixes (so
    chains hit, dedupe and evict) with fresh tails."""
    tmpl = [rng.integers(1, 2 ** 30, 4) * 2 + 1 for _ in range(n_templates)]
    out = []
    for _ in range(ticks):
        tick = []
        for _ in range(per_tick):
            t = tmpl[rng.integers(0, n_templates)][: rng.integers(1, 5)]
            tail = rng.integers(1, 2 ** 30, rng.integers(0, 3)) * 2 + 1
            tick.append([int(x) for x in np.concatenate([t, tail])])
        out.append(tick)
    return out


@pytest.mark.parametrize("cost_aware", [False, True])
def test_serve_chains_matches_jax_over_ticks(cost_aware):
    """Several ticks of ``serve_chains`` (with a short-funded chain and an
    ``insert_chains`` retry each tick) on an 8-set cache small enough to
    evict: pages, hit lengths, puts, evicted pages, stats and the final
    table equal the JAX package's."""
    rng = np.random.default_rng(1)
    kw = dict(num_sets=8, m=2, p=2, chunk_tokens=16, cost_aware=cost_aware)
    port, ref = PrefixCache(device="cpu", **kw), JaxPrefixCache(**kw)
    page = 0
    for tick in _tick_chains(rng):
        staged = []
        for c, chain in enumerate(tick):
            n = len(chain) - (c == 0 and len(chain) > 1)    # chain 0 short-funded
            staged.append(list(range(page, page + n)))
            page += n
        got, got_ev = port.serve_chains(tick, staged)
        want, want_ev = ref.serve_chains(tick, staged)
        assert got_ev == want_ev
        for g, w in zip(got, want):
            assert (g.pages, g.hitlen, g.puts) == (w.pages, w.hitlen, w.puts)
        extra = [[int(rng.integers(1, 2 ** 30)) * 2 + 1 for _ in range(2)]]
        pages = [[page, page + 1]]
        page += 2
        assert port.insert_chains(extra, pages, depths=[1], chain_lens=[3]) == \
            ref.insert_chains(extra, pages, depths=[1], chain_lens=[3])
        port.note_service_latency(page % 7)
        ref.note_service_latency(page % 7)
    ps, rs = port.stats(), ref.stats()
    assert {k: ps[k] for k in CACHE_STATS} == {k: rs[k] for k in CACHE_STATS}
    assert ps["evictions"] > 0 and ps["device_calls"] == 2 * 6
    np.testing.assert_array_equal(port.cache.table.numpy(), np.asarray(ref.cache.table))


def test_lookup_chains_matches_jax():
    """Several ticks of the split path's ``lookup_chains`` (one LOOKUP and
    one GET call) then ``insert_chains`` of each chain's missing chunks on
    an 8-set cache that evicts: pages, recycled pages, stats, device calls
    and the final table equal the JAX package's; ``lookup_chain`` and
    ``insert_chain`` are the one-chain forms."""
    rng = np.random.default_rng(6)
    kw = dict(num_sets=8, m=2, p=2, chunk_tokens=16)
    port, ref = PrefixCache(device="cpu", **kw), JaxPrefixCache(**kw)
    page = 0
    for tick in _tick_chains(rng):
        got, want = port.lookup_chains(tick), ref.lookup_chains(tick)
        assert got == want
        ins, pages, depths, lens = [], [], [], []
        for chain, hit in zip(tick, got):
            if len(hit) < len(chain):
                ins.append(chain[len(hit):])
                pages.append(list(range(page, page + len(chain) - len(hit))))
                page += len(chain) - len(hit)
                depths.append(len(hit))
                lens.append(len(chain))
        assert port.insert_chains(ins, pages, depths=depths, chain_lens=lens) == \
            ref.insert_chains(ins, pages, depths=depths, chain_lens=lens)
    chain = tick[0]
    assert port.lookup_chain(chain) == ref.lookup_chain(chain)
    extra = [int(rng.integers(1, 2 ** 30)) * 2 + 1 for _ in range(3)]
    assert port.insert_chain(extra, [page, page + 1, page + 2]) == \
        ref.insert_chain(extra, [page, page + 1, page + 2])
    assert port.lookup_chains([]) == ref.lookup_chains([]) == []
    ps, rs = port.stats(), ref.stats()
    assert {k: ps[k] for k in CACHE_STATS} == {k: rs[k] for k in CACHE_STATS}
    assert port.device_calls == ref.device_calls and ps["evictions"] > 0
    np.testing.assert_array_equal(port.cache.table.numpy(), np.asarray(ref.cache.table))


def test_pool_protocol_matches_jax():
    """A random trace of the pool's page protocol (reserve/commit/abort,
    alloc, pin/unpin, release with deferred free): refcounts and free list
    equal the JAX pool's after every step, and page content round-trips."""
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    port, ref = PagedKVPool(cfg, 12, 4, device="cpu"), JaxPool(jcfg, 12, 4)
    rng = np.random.default_rng(2)
    reserved, live, pins = [], [], []
    for _ in range(300):
        op = rng.integers(0, 6)
        if op == 0:
            a, b = port.reserve(), ref.reserve()
            assert a == b
            if a is not None:
                reserved.append(a)
        elif op == 1 and reserved:
            pg = reserved.pop(int(rng.integers(len(reserved))))
            if rng.random() < 0.5:
                port.abort(pg), ref.abort(pg)
            else:
                port.commit(pg), ref.commit(pg)
                live.append(pg)
        elif op == 2 and live:
            pg = live[int(rng.integers(len(live)))]
            port.pin(pg), ref.pin(pg)
            pins.append(pg)
        elif op == 3 and pins:
            pg = pins.pop(int(rng.integers(len(pins))))
            port.unpin(pg), ref.unpin(pg)
        elif op == 4 and live:
            pg = live.pop(int(rng.integers(len(live))))
            port.release(pg), ref.release(pg)
        elif op == 5:
            a, b = port.alloc(), ref.alloc()
            assert a == b
            if a is not None:
                live.append(a)
        np.testing.assert_array_equal(port.refcount, ref.refcount)
        assert port._free == ref._free
    kv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (cfg.n_layers, 2, 4, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
    port.write_pages([3, 7], kv, -kv)
    k, v = port.gather_pages([7])
    assert torch.equal(k, kv[:, 1].to(torch.bfloat16)) and torch.equal(v, -k)
    assert port.gather_calls == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX smoke model and its parameters, carried into the port."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, jm, jp), (cfg, make_model(cfg), tp)


def _prompts(cfg, n=10, prefix=32, n_templates=4, seed=0):
    """tests/test_paged_decode.py's trace: shared 32-token templates with
    5-13 token suffixes."""
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(1, cfg.vocab_size, prefix).astype(np.int32)
            for _ in range(n_templates)]
    return [np.concatenate([tmpl[i % n_templates],
                            rng.integers(1, cfg.vocab_size, 5 + i % 9).astype(np.int32)])
            for i in range(n)]


def _drive(port: bool, stack, prompts, *, kv_mode, n_pages=48, slots=3,
           max_len=128, max_new=6, frames=None, **engine_kw):
    """Serve ``prompts`` (with ``frames``, one per prompt, for the port's
    encoder-decoder) through the port's engine or the JAX package's."""
    cfg, model, params = stack
    if port:
        pool = PagedKVPool(cfg, n_pages=n_pages, page_tokens=16, device="cpu")
        pc = PrefixCache(num_sets=32, m=2, p=4, chunk_tokens=16, device="cpu")
        eng = ServeEngine(model, params, slots=slots, max_len=max_len,
                          prefix_cache=pc, pool=pool, kv_mode=kv_mode, **engine_kw)
        mk = Request
    else:
        pool = JaxPool(cfg, n_pages=n_pages, page_tokens=16)
        pc = JaxPrefixCache(num_sets=32, m=2, p=4, chunk_tokens=16)
        eng = jengine.ServeEngine(model, params, slots=slots, max_len=max_len,
                                  prefix_cache=pc, pool=pool, kv_mode=kv_mode,
                                  **engine_kw)
        mk = jengine.Request
    for i, p in enumerate(prompts):
        eng.submit(mk(rid=i, prompt=p, max_new_tokens=max_new,
                      **({} if frames is None else {"frames": frames[i]})))
    eng.run_until_done()
    return eng


def _summary(eng):
    st = eng.stats()
    return {"tokens": {r.rid: list(r.out_tokens) for r in eng.finished},
            "order": [r.rid for r in eng.finished],
            "prefill": [(r.rid, r.prefill_skipped, r.prefill_computed) for r in eng.finished],
            "stats": {k: st[k] for k in ENGINE_STATS},
            "refcount": eng.pool.refcount.tolist(), "free": eng.pool.free_pages,
            "cache": {k: eng.prefix_cache.stats()[k] for k in CACHE_STATS}}


# engine arguments of the decode and admission variants
MODES = {"trace": {}, "eos_short_sequential": {},
         "megastep": dict(decode_mode="megastep"),
         "roundrobin": dict(decode_mode="roundrobin"),
         "split": dict(admit_mode="split")}


@pytest.mark.parametrize("kv_mode,n_pages,variant", [
    ("paged", 48, "trace"), ("contiguous", 48, "trace"), ("paged", 6, "trace"),
    ("paged", 48, "eos_short_sequential"), ("paged", 48, "megastep"),
    ("contiguous", 48, "megastep"), ("contiguous", 48, "roundrobin"),
    ("paged", 48, "split"), ("contiguous", 48, "split")])
def test_engine_matches_jax(models, kv_mode, n_pages, variant):
    """The whole engine against JAX's on the paged-decode trace: token
    streams, finish order, prefill split, ticks, launch/sync/gather and
    megastep-window counters, resident-KV peak, prefix-cache stats and pool
    state equal.  ``n_pages=6`` runs the pool dry: the pressure retry and
    ``pool_exhausted`` paths.  ``eos_short_sequential`` adds prompts
    shorter than a chunk (plain prefill inside fused admission), an EOS
    token that the trace emits, and the sequential launch order
    (``overlap_decode=False``).  The others run megastep and round-robin
    decode and split admission."""
    (jcfg, jm, jp), port_stack = models
    prompts = _prompts(jcfg)
    kw = dict(MODES[variant])
    if variant == "eos_short_sequential":
        rng = np.random.default_rng(9)
        prompts += [rng.integers(1, jcfg.vocab_size, n).astype(np.int32) for n in (9, 12)]
        plain_run = _summary(_drive(True, port_stack, prompts, kv_mode=kv_mode))
        eos = plain_run["tokens"][0][2]                 # a token the trace emits
        kw = dict(eos_token=int(eos), overlap_decode=False)
    got = _summary(_drive(True, port_stack, prompts, kv_mode=kv_mode, n_pages=n_pages, **kw))
    want = _summary(_drive(False, (jcfg, jm, jp), prompts, kv_mode=kv_mode,
                           n_pages=n_pages, **kw))
    assert got == want
    if kv_mode == "paged":
        assert got["stats"]["gather_calls"] == 0
    if n_pages == 6:
        assert got["stats"]["pool_exhausted"] > 0
    if variant == "eos_short_sequential":
        assert any(len(t) < 6 for t in got["tokens"].values())   # EOS retired early
    if variant == "megastep":
        assert got["stats"]["megastep_windows"] > 0


def test_paged_engine_bit_identical_to_contiguous(models):
    """Inside the port, as inside the JAX package: the paged engine's
    tokens equal the contiguous engine's bit for bit, with zero prefix
    copies against the contiguous path's gathers, the same pool state, and
    a smaller resident-KV peak."""
    _, (cfg, model, params) = models
    prompts = _prompts(cfg, n=12, seed=4)
    paged = _drive(True, (cfg, model, params), prompts, kv_mode="paged")
    contig = _drive(True, (cfg, model, params), prompts, kv_mode="contiguous")
    p, c = _summary(paged), _summary(contig)
    assert p["tokens"] == c["tokens"]
    assert p["stats"]["gather_calls"] == 0 < c["stats"]["gather_calls"]
    assert (p["refcount"], p["free"]) == (c["refcount"], c["free"])
    assert p["stats"]["resident_kv_tokens_peak"] < c["stats"]["resident_kv_tokens_peak"]


def test_engine_rejects_what_is_not_ported(models):
    """What the JAX engine rejects, the port rejects.  A shed chain, which a
    bounded or sharded backend produces, no longer raises: as in the JAX
    engine it frees its slot and staged pages and waits in the retry
    queue."""
    _, (cfg, model, params) = models
    with pytest.raises(ValueError, match="decode_mode"):
        ServeEngine(model, params, decode_mode="speculative")
    with pytest.raises(ValueError, match="admit_mode"):
        ServeEngine(model, params, admit_mode="eager")
    pool = PagedKVPool(cfg, n_pages=8, page_tokens=16, device="cpu")
    pc = PrefixCache(num_sets=8, chunk_tokens=16, device="cpu")
    pc.serve_chains = lambda chains, staged, retries=None: (
        [ChainServe([], 0, [], len(c), shed=True) for c in chains], [])
    eng = ServeEngine(model, params, slots=1, max_len=64, prefix_cache=pc, pool=pool)
    eng.submit(Request(rid=0, prompt=np.ones(20, np.int32), max_new_tokens=2))
    eng.step()
    assert [r.rid for r in eng.retry_queue] == [0] and not eng.active
    assert eng._free_slots == [0] and pool.free_pages == 8
    with pytest.raises(ValueError, match="needs a prefix cache"):
        ServeEngine(model, params, kv_mode="paged")
    eng = ServeEngine(model, params, slots=1, max_len=32)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(rid=0, prompt=np.ones(30, np.int32), max_new_tokens=3))


def _assert_streams_equal_or_tied(jm, jp, prompts, got, want):
    """Every request served in full, and each port stream equal to JAX's
    but where the first step at which they differ is a bf16 tie: the JAX
    model path's logits over the prompt and JAX's tokens before that step
    put the two tokens within the model tests' logit tolerance (0.03).
    Port and JAX round bf16 sums in other orders (logits differ by up to
    about 0.008 at |logit| < 1), so random weights leave one-ulp ties that
    either side may break; past a split the streams go their own ways."""
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks)
        if got[rid] == toks:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b)
        seq = np.concatenate([prompts[rid], np.asarray(toks[:j], np.int32)])[None]
        logits = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(seq)})[0])[0]
        gap = abs(float(logits[toks[j]] - logits[got[rid][j]]))
        assert gap <= 0.03, (rid, j, toks[j], got[rid][j], gap)
