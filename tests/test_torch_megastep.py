"""Megastep decode in the port against the JAX package's, on the CPU.

``megastep_decode`` against JAX's on the same prefilled caches; the KV a
live row keeps when a window stops it at ``k_limit``; and, inside the port,
the megastep engine against the in-flight one on mixed lengths with slot
reuse, a one-tick window cap, an EOS landing mid-window and the paged KV
mode (the equalities ``tests/test_megastep_decode.py`` asserts inside the
JAX package).  On the CPU a window runs the same loop that a CUDA device
captures as a graph (``tests/test_torch_cuda.py`` holds the two together).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import cache_batch_axes as jax_cache_batch_axes
from repro.models.model import make_model as jax_make_model
from repro.serving.engine import megastep_decode as jax_megastep_decode
from repro_torch.configs import get_config
from repro_torch.core import params_from_numpy
from repro_torch.models.model import make_model
from repro_torch.serving.engine import Request, ServeEngine, megastep_decode
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache

ARCH = "phi3-mini-3.8b"
LENS = (9, 14, 11)


@pytest.fixture(scope="module")
def stacks():
    """The JAX smoke model and its parameters, and the port's on the same
    parameters."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, jm, jp), (cfg, make_model(cfg), tp)


def _prefilled(jstack, smax=64):
    """Rows of LENS prompt tokens prefilled by JAX: (jax cache, the same
    bits as port tensors, first tokens (B, 1), cur_lens (B,))."""
    jcfg, jm, jp = jstack
    rng = np.random.default_rng(5)
    cache = jm.init_cache(len(LENS), smax)
    toks = np.zeros((len(LENS), 1), np.int32)
    for b, n in enumerate(LENS):
        t = rng.integers(1, jcfg.vocab_size, n).astype(np.int32)[None]
        logits, pc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(t)})
        cache = {k: cache[k].at[:, b, :n].set(pc[k][:, 0]) for k in cache}
        toks[b, 0] = int(jnp.argmax(logits[0]))
    tcache = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
              for k, v in cache.items()}
    return cache, tcache, toks, np.asarray(LENS, np.int32)


def _port_window(tstack, tcache, toks, cur, *, steps, k_limit, live=None, rem=8,
                 eos=-1, max_len=64):
    _, tm, tp = tstack
    b = len(cur)
    live = np.ones(b, bool) if live is None else live
    return megastep_decode(
        tm.decode_step, tp, torch.from_numpy(toks), tcache, torch.from_numpy(cur),
        torch.from_numpy(live), torch.full((b,), rem, dtype=torch.int32), eos=eos,
        max_len=max_len, steps=steps, k_limit=torch.tensor(k_limit, dtype=torch.int32),
        park=torch.zeros(b, dtype=torch.int32))


@pytest.mark.parametrize("k_limit", [4, 2])
def test_megastep_decode_matches_jax(stacks, k_limit):
    """A steps = 4 window at k_limit 4 and 2 on JAX-prefilled caches: tokens,
    emit masks, cur_lens, live and last tokens equal JAX's; lanes past the
    limit emit nothing (-1) and leave the rows live."""
    jstack, tstack = stacks
    jcfg, jm, jp = jstack
    jcache, tcache, toks, cur = _prefilled(jstack)
    b = len(cur)
    _, jlt, jcu, jlv, jtoks, jemits = jax_megastep_decode(
        jm.decode_step, jp, jnp.asarray(toks), jcache, jnp.asarray(cur),
        np.ones(b, bool), np.full(b, 8, np.int32), eos=-1, max_len=64, steps=4,
        k_limit=k_limit, cache_axes=jax_cache_batch_axes(jcfg))
    lt, cu, lv, ttoks, temits = _port_window(tstack, tcache, toks, cur, steps=4,
                                             k_limit=k_limit)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(temits.numpy(), np.asarray(jemits))
    np.testing.assert_array_equal(cu.numpy(), np.asarray(jcu))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt))
    assert temits.numpy()[:k_limit].all() and not temits.numpy()[k_limit:].any()
    assert (ttoks.numpy()[k_limit:] == -1).all()
    np.testing.assert_array_equal(cu.numpy(), cur + k_limit)
    assert lv.numpy().all()


def test_rows_past_the_limit_keep_their_kv(stacks):
    """A window stopped at k_limit 2 of 4 leaves the KV of its live rows bit
    for bit as two stepwise decode launches leave it, once the next real
    step has run on both: a row past the limit decodes at its own cur_len,
    so what it writes there is what that next step writes.  An idle row
    (live False) parks at position 0 and never emits."""
    jstack, tstack = stacks
    _, tm, tp = tstack
    _, tcache, toks, cur = _prefilled(jstack)
    loop = {k: v.clone() for k, v in tcache.items()}
    live = np.array([True, True, False])
    lt, cu, lv, ttoks, _ = _port_window(tstack, tcache, toks, cur, steps=4,
                                        k_limit=2, live=live)
    assert (ttoks.numpy()[:, 2] == -1).all() and int(cu[2]) == cur[2]
    assert not bool(lv[2])
    # the oracle: two stepwise launches of the live rows, the idle row parked
    lt_l, cu_l = torch.from_numpy(toks), torch.from_numpy(cur)
    park = torch.from_numpy(np.where(live, cur, 0).astype(np.int32))
    for _ in range(2):
        logits, loop = tm.decode_step(tp, lt_l, loop, torch.where(
            torch.from_numpy(live), cu_l, park))
        lt_l = torch.argmax(logits, -1).to(torch.int32)[:, None]
        cu_l = cu_l + torch.from_numpy(live.astype(np.int32))
    np.testing.assert_array_equal(lt.numpy()[live], lt_l.numpy()[live])
    rows = np.flatnonzero(live)
    # positions the rows really wrote are bit-equal already
    for r in rows:
        for k in ("k", "v"):
            assert torch.equal(tcache[k][:, r, : int(cu[r])], loop[k][:, r, : int(cu[r])])
    # ... and after the next real step on both, the whole rows are
    nxt = torch.from_numpy(np.where(live, cu.numpy(), 0).astype(np.int32))
    l1, _ = tm.decode_step(tp, lt, tcache, nxt)
    l2, _ = tm.decode_step(tp, lt_l, loop, nxt)
    for k in ("k", "v"):
        assert torch.equal(tcache[k][:, rows], loop[k][:, rows])
    assert torch.equal(l1[rows], l2[rows])


# ---------------------------------------------------------------------------
# the engine: megastep against in-flight, inside the port
# ---------------------------------------------------------------------------

def _drive(tstack, prompts, mode, *, max_new, slots=2, eos=-1, kv_mode="contiguous",
           max_window=16):
    cfg, model, params = tstack
    pool = PagedKVPool(cfg, n_pages=64, page_tokens=16, device="cpu")
    pc = PrefixCache(num_sets=64, m=2, p=4, chunk_tokens=16, device="cpu")
    eng = ServeEngine(model, params, slots=slots, max_len=128, prefix_cache=pc,
                      pool=pool, decode_mode=mode, kv_mode=kv_mode, eos_token=eos,
                      max_window=max_window)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new[i]))
    return eng, eng.run_until_done()


def _toks(eng):
    return {r.rid: r.out_tokens for r in eng.finished}


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


def test_megastep_engine_token_identical_with_fewer_launches(stacks):
    """Mixed lengths and slot reuse: the megastep engine emits the in-flight
    engine's streams on the same ticks (finish order, p50/p99 and resident
    peak equal) with fewer launches and host syncs; ``max_window=1``
    degenerates to the per-tick engine."""
    _, tstack = stacks
    prompts = _prompts(tstack[0], 10, (18, 31, 44, 23, 37))
    max_new = [5, 9, 13, 7, 17]
    eng_i, ticks_i = _drive(tstack, prompts, "inflight", max_new=max_new)
    eng_m, ticks_m = _drive(tstack, prompts, "megastep", max_new=max_new)
    assert _toks(eng_m) == _toks(eng_i)
    assert ticks_m == ticks_i
    assert [r.rid for r in eng_m.finished] == [r.rid for r in eng_i.finished]
    st_i, st_m = eng_i.stats(), eng_m.stats()
    for k in ("service_ticks_p50", "service_ticks_p99", "resident_kv_tokens_peak",
              "resident_kv_tokens_mean", "decode_tokens"):
        assert st_m[k] == st_i[k], k
    assert st_m["megastep_windows"] >= 1 and st_m["mean_window"] > 1.0
    assert st_m["decode_launches"] < st_i["decode_launches"]
    assert st_m["host_syncs"] < st_i["host_syncs"]
    assert st_m["drain_launches_per_token"] < 1.0 == st_i["drain_launches_per_token"]
    eng_1, ticks_1 = _drive(tstack, prompts, "megastep", max_new=max_new, max_window=1)
    assert _toks(eng_1) == _toks(eng_i) and ticks_1 == ticks_i
    st_1 = eng_1.stats()
    assert st_1["mean_window"] == 1.0
    assert st_1["decode_launches"] == st_i["decode_launches"]


def test_eos_mid_window_token_identical(stacks):
    """An EOS that lands inside a window retires the row on the in-flight
    engine's tick: streams and ticks equal, the stream really cut short."""
    _, tstack = stacks
    prompts = _prompts(tstack[0], 11, (20, 35, 27, 42))
    max_new = [12] * 4
    ref, _ = _drive(tstack, prompts, "inflight", max_new=max_new)
    eos = _toks(ref)[1][5]
    eng_i, ticks_i = _drive(tstack, prompts, "inflight", max_new=max_new, eos=eos)
    eng_m, ticks_m = _drive(tstack, prompts, "megastep", max_new=max_new, eos=eos)
    assert _toks(eng_m) == _toks(eng_i) and ticks_m == ticks_i
    assert [r.rid for r in eng_m.finished] == [r.rid for r in eng_i.finished]
    assert any(r.out_tokens[-1] == eos and len(r.out_tokens) < 12 for r in eng_m.finished)
    assert eng_m.stats()["megastep_windows"] >= 1


def test_paged_megastep_token_identical_zero_gathers(stacks):
    """Paged megastep equals paged in-flight and contiguous in-flight, with
    no prefix copy."""
    _, tstack = stacks
    cfg = tstack[0]
    rng = np.random.default_rng(12)
    shared = rng.integers(1, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in _prompts(cfg, 13, (5, 11, 8, 3))]
    max_new = [9, 6, 9, 4]
    eng_c, _ = _drive(tstack, prompts, "inflight", max_new=max_new, slots=3)
    eng_pi, _ = _drive(tstack, prompts, "inflight", max_new=max_new, slots=3,
                       kv_mode="paged")
    eng_pm, _ = _drive(tstack, prompts, "megastep", max_new=max_new, slots=3,
                       kv_mode="paged")
    assert _toks(eng_pm) == _toks(eng_pi) == _toks(eng_c)
    st = eng_pm.stats()
    assert st["gather_calls"] == 0 < eng_c.stats()["gather_calls"]
    assert st["megastep_windows"] >= 1
    assert st["decode_launches"] < eng_pi.stats()["decode_launches"]
