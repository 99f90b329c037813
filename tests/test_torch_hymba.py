"""The port's hymba hybrid (attention and Mamba heads, meta tokens) against
the JAX package's, on the CPU, at smoke size; and the engine's freeze of
recurrent state.

Mamba alone (the chunked scan, ``mamba_apply`` and ``mamba_decode``), the
model's prefill and teacher-forced decode, and the whole ``ServeEngine``
(contiguous, as the JAX engine serves hymba: no prefix cache) on the same
numpy-seeded inputs and the JAX parameters carried by ``params_from_numpy``.
Inside the port, exactly: megastep and round-robin decode give the in-flight
tokens, a frozen row's Mamba state stays bit-equal through a window, and the
window graph's warm-up (``k_limit = 0``) changes no state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.model import cache_batch_axes as jax_cache_batch_axes
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models.model import cache_batch_axes
from repro_torch.serving.engine import Request, ServeEngine, megastep_decode, state_leaves
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache
from test_torch_models import LAYER_TOL, _bf16, _check_prefill_and_decode, _close, _pair
from test_torch_serving import _assert_streams_equal_or_tied, _drive, _prompts, _summary

ARCH = "hymba-1.5b"
# The scan alone on equal f32 inputs: the Hillis-Steele order against XLA's
# associative scan, a few f32 ulps of the state's magnitude
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
# Mamba on bf16 inputs: the projections round in bf16 (one ulp, 2^-8
# relative, in either framework), and the f32 state carries it
STATE_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(scope="module")
def hymba():
    """(jax cfg, port cfg, jax model, jax params, port model, port params)."""
    return _pair(jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True))


def _mamba(pair_):
    """Layer 0's Mamba parameters, JAX's and the port's."""
    _, cfg, _, jp, _, tp = pair_
    return jax.tree.map(lambda x: x[0], jp["blocks"]["mamba"]), tp["blocks"][0]["mamba"], cfg


def _close_state(js, ts):
    np.testing.assert_allclose(np.asarray(js["h"]), ts["h"].numpy(), **STATE_TOL)
    _close(js["conv"], ts["conv"], LAYER_TOL)
    assert ts["h"].dtype == torch.float32 and ts["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("length", [40, 64, 256])
def test_sel_scan_chunk_matches_jax(length):
    """The chunk scan alone, on equal f32 inputs with a's of a real Mamba
    (exp of -dt * A, in (0, 1)): within SCAN_TOL of ``lax.associative_scan``
    for L not a power of two, and at 64 and 256 (hymba's full-width chunk)."""
    rng = np.random.default_rng(length)
    a = np.exp(-rng.uniform(0, 2, (2, length, 6, 4))).astype(np.float32)
    bx = rng.standard_normal((2, length, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jh, jlast = jssm._sel_scan_chunk(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    th, tlast = ssm._sel_scan_chunk(*(torch.from_numpy(x) for x in (a, bx, h0)))
    np.testing.assert_allclose(np.asarray(jh), th.numpy(), **SCAN_TOL)
    np.testing.assert_array_equal(th[:, -1].numpy(), tlast.numpy())
    np.testing.assert_allclose(np.asarray(jlast), tlast.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("length", [9, 16, 37])
def test_mamba_apply_and_decode_match_jax(hymba, length):
    """``mamba_apply`` with S below, at and above the chunk (16, 37 not a
    multiple: the last chunk padded) against JAX's: the output within
    LAYER_TOL, the returned state (``h`` f32 within STATE_TOL, ``conv`` from
    the last three real positions) too; then five ``mamba_decode`` steps
    from that state."""
    jpm, tpm, cfg = _mamba(hymba)
    rng = np.random.default_rng(length)
    jx, tx = _bf16(rng, 2, length, cfg.d_model)
    kw = dict(d_state=cfg.ssm_state, chunk=cfg.ssm_chunk, return_state=True)
    jy, js = jssm.mamba_apply(jpm, jx, **kw)
    ty, ts = ssm.mamba_apply(tpm, tx, **kw)
    _close(jy, ty, LAYER_TOL)
    _close_state(js, ts)
    # conv: the last three real positions of the conv input
    assert torch.equal(ts["conv"], (tx @ tpm["w_in"])[:, -3:, :cfg.d_model])
    for _ in range(5):
        jx, tx = _bf16(rng, 2, 1, cfg.d_model)
        jy, js = jssm.mamba_decode(jpm, jx, js, d_state=cfg.ssm_state)
        ty, ts = ssm.mamba_decode(tpm, tx, ts, d_state=cfg.ssm_state)
        _close(jy, ty, LAYER_TOL)
        _close_state(js, ts)


def test_hymba_prefill_and_teacher_forced_decode_match_jax(hymba):
    """The model: meta tokens prepended (positions over S + 8), KV over
    meta and prompt, the Mamba state carried from the prefill; six
    teacher-forced decode steps at per-row lengths, logits within DEEP_TOL
    and greedy tokens equal up to bf16 ties; the cache's batch axes are
    JAX's.  The KV is compared at layer 0, with layer 0's Mamba state: a
    hymba block is three bf16 sublayers (attention, Mamba, SwiGLU), so
    layer 1's KV lies deeper than DEEP_TOL's two bf16 layers (its gap
    reaches 0.032, two bf16 ulps of its largest |K|, at an element of 0.07);
    the logits hold all of it to DEEP_TOL."""
    _check_prefill_and_decode(hymba, kv_layers=1)
    jcfg, cfg, jm, jp, tm, tp = hymba
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tc["k"].shape[2] == 20 + cfg.meta_tokens
    _close_state(jax.tree.map(lambda x: x[0], jc["mamba"]),
                 {n: x[0] for n, x in tc["mamba"].items()})
    assert cache_batch_axes(cfg) == jax_cache_batch_axes(jcfg)
    tc = tm.init_cache(2, 40, device="cpu")
    jc = jm.init_cache(2, 40)
    assert jax.tree.map(lambda x: (x.shape, x.dtype.name), jc) == \
        {k: ({n: (tuple(x.shape), str(x.dtype)[6:]) for n, x in v.items()}
             if isinstance(v, dict) else (tuple(v.shape), str(v.dtype)[6:]))
         for k, v in tc.items()}


def _stacks(pair_):
    jcfg, cfg, jm, jp, tm, tp = pair_
    return (jcfg, jm, jp), (cfg, tm, tp)


@pytest.mark.parametrize("decode_mode", ["inflight", "roundrobin", "megastep"])
def test_hymba_engine_matches_jax(hymba, decode_mode):
    """hymba-smoke through the contiguous engine against the JAX engine:
    finish order, prefill split (all computed: no prefix cache), ticks,
    counters and stats equal, and the token streams equal but where they
    split at a bf16 tie.  Prompts of 37-45 tokens behind 8 meta tokens: the
    window of 16 binds."""
    jstack, port_stack = _stacks(hymba)
    prompts = _prompts(jstack[0])
    kw = dict(kv_mode="contiguous", decode_mode=decode_mode)
    got = _summary(_drive(True, port_stack, prompts, **kw))
    want = _summary(_drive(False, jstack, prompts, **kw))
    _assert_streams_equal_or_tied(jstack[1], jstack[2], prompts, got.pop("tokens"),
                                  want.pop("tokens"))
    assert got == want
    assert all(skipped == 0 for _, skipped, _ in got["prefill"])
    assert got["cache"]["hits"] + got["cache"]["misses"] == 0
    if decode_mode == "megastep":
        assert got["stats"]["megastep_windows"] > 0


def test_hymba_megastep_and_roundrobin_equal_inflight(hymba):
    """Inside the port, exactly: megastep windows (rows past ``k_limit`` and
    retired rows frozen) and round-robin decode (rows above the minimum
    frozen) give the in-flight engine's tokens, token for token, and the
    same finish order and prefill split."""
    _, port_stack = _stacks(hymba)
    prompts = _prompts(port_stack[0], seed=2)
    runs = {m: _summary(_drive(True, port_stack, prompts, kv_mode="contiguous",
                               decode_mode=m, max_new=9))
            for m in ("inflight", "megastep", "roundrobin")}
    for m in ("megastep", "roundrobin"):
        assert runs[m]["tokens"] == runs["inflight"]["tokens"], m
        assert sorted(runs[m]["prefill"]) == sorted(runs["inflight"]["prefill"]), m
    assert runs["megastep"]["order"] == runs["inflight"]["order"]
    assert runs["megastep"]["stats"]["megastep_windows"] > 0
    assert runs["roundrobin"]["stats"]["ticks"] > runs["inflight"]["stats"]["ticks"]


def _state(cache):
    return {n: cache["mamba"][n].clone() for n in ("h", "conv")}


def test_frozen_row_keeps_its_mamba_state(hymba):
    """The port's form of ``test_cache_batch_axes_freezes_every_family``: a
    two-step window with row 1 not live leaves row 1's Mamba leaves (and
    its KV) bit-equal, emits nothing for it and keeps its cur_len and last
    token; row 0 emits the tokens of the plain decode loop.  Then, with
    ``k_limit`` 1 of 2, row 0's state is the state after one step."""
    _, cfg, _, _, tm, tp = hymba
    rng = np.random.default_rng(3)
    cache0 = tm.init_cache(2, 32, device="cpu")
    for n in ("h", "conv"):
        cache0["mamba"][n].copy_(torch.from_numpy(
            rng.standard_normal(tuple(cache0["mamba"][n].shape)).astype(np.float32)))
    leaves = state_leaves(cache_batch_axes(cfg))
    last = torch.tensor([[5], [9]], dtype=torch.int32)
    cur = torch.tensor([3, 4], dtype=torch.int32)

    def window(cache, k_limit, live=(True, False)):
        return megastep_decode(tm.decode_step, tp, last, cache, cur, torch.tensor(live),
                               torch.tensor([6, 6], dtype=torch.int32), eos=-1,
                               max_len=32, steps=2, k_limit=torch.tensor(k_limit),
                               park=torch.zeros(2, dtype=torch.int32), state=leaves)

    cache = {k: (v.clone() if k != "mamba" else _state(cache0)) for k, v in cache0.items()}
    lt, cu, _, toks, emits = window(cache, 2)
    for n in ("h", "conv"):
        assert torch.equal(cache["mamba"][n][:, 1], cache0["mamba"][n][:, 1]), n
        assert not torch.equal(cache["mamba"][n][:, 0], cache0["mamba"][n][:, 0]), n
    assert not emits[:, 1].any() and (toks[:, 1] == -1).all()
    assert int(cu[1]) == 4 and int(lt[1, 0]) == 9 and int(cu[0]) == 5
    # row 0: the plain loop (every row advancing, row 1 parked at 0)
    loop = {k: (v.clone() if k != "mamba" else _state(cache0)) for k, v in cache0.items()}
    lt_l = last
    for i in range(2):
        logits, loop = tm.decode_step(tp, lt_l, loop, torch.tensor([3 + i, 0]))
        lt_l = torch.argmax(logits, -1).to(torch.int32)[:, None]
        assert int(toks[i, 0]) == int(lt_l[0, 0])
    for n in ("h", "conv"):
        assert torch.equal(cache["mamba"][n][:, 0], loop["mamba"][n][:, 0]), n

    # k_limit 1 of 2: row 0 keeps the state of its one emitted step
    one = {k: (v.clone() if k != "mamba" else _state(cache0)) for k, v in cache0.items()}
    _, cu1, _, _, emits1 = window(one, 1, live=(True, True))
    step = {k: (v.clone() if k != "mamba" else _state(cache0)) for k, v in cache0.items()}
    _, step = tm.decode_step(tp, last, step, cur)
    assert emits1[0].all() and not emits1[1].any()
    np.testing.assert_array_equal(cu1.numpy(), [4, 5])
    for n in ("h", "conv"):
        assert torch.equal(one["mamba"][n], step["mamba"][n]), n


def test_window_warm_up_leaves_the_state_bit_equal(hymba):
    """``capture_window``'s warm-up runs the window body on the engine's
    state with ``k_limit = 0``; run eagerly on the CPU, mid-serve (two live
    rows, a retired one's idle slot), it leaves every Mamba leaf bit-equal
    and the KV every live row has written, and emits nothing."""
    _, cfg, _, _, tm, tp = hymba
    eng = ServeEngine(tm, tp, slots=3, max_len=128,
                      prefix_cache=PrefixCache(num_sets=32, chunk_tokens=16, device="cpu"),
                      pool=PagedKVPool(cfg, n_pages=8, page_tokens=16, device="cpu"))
    for i, (p, n) in enumerate(zip(_prompts(cfg, n=3), (2, 8, 8))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    for _ in range(3):
        eng.step()                    # request 0 has retired: its slot is idle
    assert len(eng.active) == 2 and len(eng._free_slots) == 1
    before = {"k": eng.cache["k"].clone(), "v": eng.cache["v"].clone(),
              **_state(eng.cache)}
    out = eng._window_body(eng._tensor(eng._window_inputs(0)), 4)
    for n in ("h", "conv"):
        assert torch.equal(eng.cache["mamba"][n], before[n]), n
    for r in eng.active.values():
        n = int(eng.cur_len[r.slot]) + cfg.meta_tokens
        for k in ("k", "v"):
            assert torch.equal(eng.cache[k][:, r.slot, :n], before[k][:, r.slot, :n])
    assert not out[4:8].any() and (out[:4] == -1).all()


def test_launcher_serves_hymba_contiguous_only(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch hymba-1.5b``
    serves every request through plain admission (the prefix cache stays
    unused, as in the JAX engine); ``--kv-mode paged`` raises."""
    serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "6"])
    out = capsys.readouterr().out
    assert "6 requests in" in out and "skipped=0 " in out and "'device_calls': 0" in out
    with pytest.raises(ValueError, match="attention decoder without meta tokens"):
        serve.build(serve.parser().parse_args(["--device", "cpu", "--arch", ARCH,
                                               "--kv-mode", "paged"]))
