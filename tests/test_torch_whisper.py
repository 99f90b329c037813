"""The port's Whisper encoder-decoder against the JAX package's, on the CPU,
at smoke size; and the engine's serve of it.

The sinusoids, the encoder block, the cross-attention (``cross_kv``,
``_cross_attend``), the model's prefill (encoder and decoder) and
teacher-forced decode, on the same numpy-seeded inputs and frames and the
JAX parameters carried by ``params_from_numpy``.  The JAX engine cannot
serve Whisper (no frames reach its prefill; ROADMAP Queue 3), so the port's
``ServeEngine`` (contiguous, in-flight and megastep) is held against the
JAX *model* path per request.  Inside the port, exactly: megastep and
round-robin give the in-flight tokens, a frozen row keeps its
cross-attention KV and its KV bit-equal through a window, and the window
graph's warm-up (``k_limit = 0``) changes nothing a live row has written.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.models.model import cache_batch_axes as jax_cache_batch_axes
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm
from repro_torch.models.model import cache_batch_axes
from repro_torch.serving.engine import Request, ServeEngine, megastep_decode, state_leaves
from test_torch_models import ATTN_TOL, DEEP_TOL, LAYER_TOL, _assert_same_greedy, _bf16, _close, _pair
from test_torch_serving import _prompts
from test_torch_xlstm import (assert_plain_admission, assert_streams_equal_or_tied,
                              jax_model_streams, serve_contiguous)

ARCH = "whisper-medium"
# a sinusoid: sin and cos in f32 from other libraries, rounded to bf16, so
# equal but where one lies at a rounding boundary: one bf16 ulp at |x| <= 1
SINUSOID_TOL = dict(rtol=0, atol=2 ** -8)


@pytest.fixture(scope="module")
def whisper():
    """(jax cfg, port cfg, jax model, jax params, port model, port params)."""
    return _pair(jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True))


def _frames(cfg, n, seed=0):
    """``n`` requests' frames (enc_len, d_model), standard normal as f32
    (JAX and the port round them to bf16 alike)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _bf16_frames(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d,offset", [(30, 64, 0), (7, 64, 100), (1500, 1024, 0)])
def test_sinusoid_positions_match_jax(s, d, offset):
    """``sinusoid_positions`` against JAX's within one bf16 ulp, at the
    smoke encoder's 30 frames, decoder positions past an offset, and
    whisper-medium's 1500 frames of width 1024."""
    want = jtfm.sinusoid_positions(s, d, offset)
    got = tfm.sinusoid_positions(s, d, offset)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (s, d)
    _close(want, got, SINUSOID_TOL)


@pytest.mark.parametrize("pos", [0, 37, [3, 90, 255, 0]])
def test_sinusoid_at_matches_jax(pos):
    """``_sinusoid_at`` of an int (1, 1, d) and of per-row positions (B, 1,
    d) against JAX's within one bf16 ulp; a (B,) tensor on the device gives
    the same as the host values."""
    want = jmodel._sinusoid_at(jnp.asarray(pos), 64)
    got = tmodel._sinusoid_at(torch.as_tensor(pos), 64)
    assert tuple(got.shape) == tuple(want.shape)
    _close(want, got, SINUSOID_TOL)
    assert torch.equal(got, tmodel._sinusoid_at(pos, 64))


def _dec0(pair_, name):
    _, cfg, _, jp, _, tp = pair_
    return jax.tree.map(lambda x: x[0], jp["dec"][name]), tp["dec"][0][name], cfg


def test_cross_kv_and_cross_attend_match_jax(whisper):
    """Layer 0's cross-attention: ``cross_kv`` of an encoder output (B, 30,
    D) within LAYER_TOL of JAX's, and ``_cross_attend`` of 5 queries (and
    of one, as decode gives it) over those K/V within ATTN_TOL."""
    jpc, tpc, cfg = _dec0(whisper, "cross_attn")
    rng = np.random.default_rng(4)
    jenc, tenc = _bf16(rng, 2, cfg.enc_len, cfg.d_model)
    jk, jv = jtfm.cross_kv(cfg, jpc, jenc)
    tk, tv = tfm.cross_kv(cfg, tpc, tenc)
    assert tuple(tk.shape) == (2, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
    _close(jk, tk, LAYER_TOL)
    _close(jv, tv, LAYER_TOL)
    for s in (5, 1):
        jx, tx = _bf16(rng, 2, s, cfg.d_model)
        _close(jtfm._cross_attend(cfg, jpc, jx, jk, jv),
               tfm._cross_attend(cfg, tpc, tx, tk, tv), ATTN_TOL)


def test_enc_block_apply_matches_jax(whisper):
    """Each encoder block on the same input: bidirectional attention (no
    RoPE, chunks of 16 over 30 frames) and the GeLU MLP, within ATTN_TOL."""
    _, cfg, _, jp, _, tp = whisper
    rng = np.random.default_rng(5)
    jx, tx = _bf16(rng, 2, cfg.enc_len, cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(cfg.enc_len)[None], (2, cfg.enc_len))
    for l in range(cfg.n_enc_layers):
        jpl = jax.tree.map(lambda x, l=l: x[l], jp["enc"])
        _close(jtfm.enc_block_apply(cfg, jpl, jx, pos),
               tfm.enc_block_apply(cfg, tp["enc"][l], tx, None), ATTN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_whisper_prefill_and_teacher_forced_decode_match_jax(whisper):
    """``prefill`` of three 24-token prompts with their frames: logits
    within DEEP_TOL and greedy tokens equal up to bf16 ties, the decoder KV
    and the cross-attention KV of both layers within DEEP_TOL (the encoder
    is two layers deep); then six teacher-forced ``decode_step``s at per-row
    lengths (row 1 rewinds to 20), logits within DEEP_TOL.  The cache has
    JAX's tree, shapes, dtypes and batch axes."""
    jcfg, cfg, jm, jp, tm, tp = whisper
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (3, 24)).astype(np.int32)
    fr = _frames(cfg, 3, seed=7)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(fr, jnp.bfloat16)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "frames": _bf16_frames(fr)})
    _close(jl, tl, DEEP_TOL)
    _assert_same_greedy(jl, tl)
    for name in ("k", "v", "xk", "xv"):
        _close(jc[name], tc[name], DEEP_TOL)
    assert cache_batch_axes(cfg) == jax_cache_batch_axes(jcfg)
    assert state_leaves(cache_batch_axes(cfg)) == []
    jcache, tcache = jm.init_cache(3, 40), tm.init_cache(3, 40, device="cpu")
    assert {n: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for n, x in tcache.items()} == {n: (x.shape, x.dtype.name)
                                            for n, x in jcache.items()}
    for name in ("k", "v"):
        jcache[name] = jcache[name].at[:, :, :24].set(jc[name])
        tcache[name][:, :, :24] = tc[name]
    for name in ("xk", "xv"):
        jcache[name], tcache[name] = jc[name], tc[name].clone()
    cur = np.array([24, 20, 24], np.int32)
    feed = rng.integers(1, cfg.vocab_size, (6, 3, 1)).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    for step in range(6):
        jl, jcache = jdecode(jp, jnp.asarray(feed[step]), jcache, jnp.asarray(cur))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(feed[step]), tcache,
                                    torch.from_numpy(cur))
        _close(jl, tl, DEEP_TOL)
        _assert_same_greedy(jl, tl)
        cur = cur + 1
    assert torch.equal(tcache["xk"], tc["xk"])          # decode never writes it


def test_whisper_params_carry_and_init_draw_the_jax_tree(whisper):
    """``params_from_numpy`` splits the encoder (``enc``, n_enc_layers) and
    decoder (``dec``, n_layers) stacks and carries ``enc_norm`` and the head,
    each leaf with its JAX value and dtype (LayerNorm scale and bias f32);
    the port's init draws the same shapes and dtypes, as many parameters as
    ``param_count`` says."""
    jcfg, cfg, jm, jp, tm, tp = whisper
    stacks = {"enc": cfg.n_enc_layers, "dec": cfg.n_layers}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = [k.key for k in path]
        arr = np.asarray(leaf)
        for ix in ([(i,) for i in range(stacks[names[0]])] if names[0] in stacks else [()]):
            t = tp[names[0]]
            t = t[ix[0]] if ix else t
            for name in names[1:]:
                t = t[name]
            assert str(t.dtype).removeprefix("torch.") == arr.dtype.name, names
            np.testing.assert_array_equal(arr[ix].astype(np.float32), t.float().numpy(),
                                          err_msg=str(names))
    assert tp["enc_norm"]["bias"].dtype == torch.float32
    n_jax = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(x.numel() for x in tp.parameters()) == n_jax
    fresh = tm.init(torch.Generator(device="cpu").manual_seed(0))
    assert sum(x.numel() for x in fresh.parameters()) == cfg.param_count() == n_jax
    assert {n: (tuple(x.shape), x.dtype) for n, x in fresh.named_parameters()} == \
        {n: (tuple(x.shape), x.dtype) for n, x in tp.named_parameters()}


def test_whisper_full_width_config_and_count():
    """whisper-medium at its published widths: 24 encoder and 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab 51865, 1500
    frames.  ``param_count`` is every leaf the JAX init makes (its shapes
    traced, not drawn): JAX's analytic count, 0.811B, plus the LayerNorms."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == 64 and cfg.enc_len == 1500
    shapes = jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0))
    assert cfg.param_count() == sum(x.size for x in jax.tree.leaves(shapes))
    norms = 2 * cfg.d_model * (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2)
    assert cfg.param_count() == jcfg.param_count() + norms
    assert round(jcfg.param_count() / 1e9, 3) == 0.811


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(whisper):
    """Prompts, their frames, and the JAX model path's streams for them."""
    jcfg, _, jm, jp, _, _ = whisper
    prompts = _prompts(jcfg)
    frames = _frames(jcfg, len(prompts), seed=1)
    return prompts, frames, jax_model_streams(jm, jp, jcfg, prompts, 6, frames=frames)


@pytest.mark.parametrize("decode_mode", ["inflight", "megastep"])
def test_whisper_engine_matches_jax_model_path(whisper, reference, decode_mode):
    """whisper-smoke through the port's contiguous engine (ten prompts of
    37-45 tokens, each with its frames, three slots, six new tokens) gives
    the JAX model path's greedy streams, or splits from one at a bf16 tie;
    every prompt prefilled whole (no prefix cache call)."""
    _, cfg, _, _, tm, tp = whisper
    prompts, frames, ref = reference
    out = serve_contiguous((cfg, tm, tp), prompts, [_bf16_frames(f) for f in frames],
                           decode_mode=decode_mode)
    assert_streams_equal_or_tied(out["tokens"], ref)
    assert_plain_admission(out, prompts)
    if decode_mode == "megastep":
        assert out["stats"]["megastep_windows"] > 0


def test_whisper_megastep_and_roundrobin_equal_inflight(whisper):
    """Inside the port, exactly: megastep and round-robin decode give the
    in-flight engine's tokens, token for token, and the same prefill split;
    megastep also its finish order and ticks."""
    _, cfg, _, _, tm, tp = whisper
    prompts = _prompts(cfg, seed=2)
    frames = [_bf16_frames(f) for f in _frames(cfg, len(prompts), seed=2)]
    runs = {m: serve_contiguous((cfg, tm, tp), prompts, frames, decode_mode=m, max_new=9)
            for m in ("inflight", "megastep", "roundrobin")}
    for m in ("megastep", "roundrobin"):
        assert runs[m]["tokens"] == runs["inflight"]["tokens"], m
        assert sorted(runs[m]["prefill"]) == sorted(runs["inflight"]["prefill"]), m
    assert runs["megastep"]["order"] == runs["inflight"]["order"]
    assert runs["megastep"]["stats"]["ticks"] == runs["inflight"]["stats"]["ticks"]
    assert runs["megastep"]["stats"]["megastep_windows"] > 0


def test_frozen_row_keeps_its_caches(whisper):
    """The port's form of ``test_cache_batch_axes_freezes_every_family``:
    from random caches, a two-step window with row 1 not live leaves row
    1's cross-attention KV bit-equal and its KV too but at its park
    position 0 (an idle row's write there, which its next prefill
    overwrites), emits nothing for it and keeps its cur_len and last token;
    row 0 emits the tokens of the plain decode loop and writes its KV."""
    _, cfg, _, _, tm, tp = whisper
    rng = np.random.default_rng(3)
    cache0 = tm.init_cache(2, 32, device="cpu")
    for x in cache0.values():
        x.copy_(torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)))
    last = torch.tensor([[5], [9]], dtype=torch.int32)
    cur = torch.tensor([3, 4], dtype=torch.int32)
    cache = {n: x.clone() for n, x in cache0.items()}
    lt, cu, _, toks, emits = megastep_decode(
        tm.decode_step, tp, last, cache, cur, torch.tensor([True, False]),
        torch.tensor([6, 6], dtype=torch.int32), eos=-1, max_len=32, steps=2,
        k_limit=torch.tensor(2), park=torch.zeros(2, dtype=torch.int32),
        state=state_leaves(cache_batch_axes(cfg)))
    for n in ("xk", "xv"):
        assert torch.equal(cache[n], cache0[n]), n
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, 1, 1:], cache0[n][:, 1, 1:]), n
        assert not torch.equal(cache[n][:, 0, 3:5], cache0[n][:, 0, 3:5]), n
    assert not emits[:, 1].any() and (toks[:, 1] == -1).all()
    assert int(cu[1]) == 4 and int(lt[1, 0]) == 9 and int(cu[0]) == 5
    loop, lt_l = {n: x.clone() for n, x in cache0.items()}, last
    for i in range(2):
        logits, loop = tm.decode_step(tp, lt_l, loop, torch.tensor([3 + i, 0]))
        lt_l = torch.argmax(logits, -1).to(torch.int32)[:, None]
        assert int(toks[i, 0]) == int(lt_l[0, 0])
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, 0], loop[n][:, 0]), n


def test_window_warm_up_changes_nothing_written(whisper):
    """``capture_window``'s warm-up (``k_limit = 0``), run eagerly on the CPU
    mid-serve (two live rows, a retired one's idle slot), leaves the
    cross-attention KV and every position a live row has written
    bit-equal, and emits nothing."""
    _, cfg, _, _, tm, tp = whisper
    eng = ServeEngine(tm, tp, slots=3, max_len=128)
    frames = _frames(cfg, 3, seed=4)
    for i, (p, n) in enumerate(zip(_prompts(cfg, n=3), (2, 8, 8))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n, frames=_bf16_frames(frames[i])))
    for _ in range(3):
        eng.step()                    # request 0 has retired: its slot is idle
    assert len(eng.active) == 2 and len(eng._free_slots) == 1
    before = {n: x.clone() for n, x in eng.cache.items()}
    out = eng._window_body(eng._tensor(eng._window_inputs(0)), 4)
    for n in ("xk", "xv"):
        assert torch.equal(eng.cache[n], before[n]), n
    for r in eng.active.values():
        s = int(eng.cur_len[r.slot])
        for n in ("k", "v"):
            assert torch.equal(eng.cache[n][:, r.slot, :s], before[n][:, r.slot, :s])
    assert not out[4:8].any() and (out[:4] == -1).all()


def test_engine_requires_frames_for_the_encoder_decoder_only(whisper):
    """A Whisper request without frames, or frames on another family's
    request, is refused at ``submit``."""
    _, cfg, _, _, tm, tp = whisper
    eng = ServeEngine(tm, tp, slots=1, max_len=64)
    with pytest.raises(ValueError, match="needs its frames"):
        eng.submit(Request(rid=0, prompt=np.ones(8, np.int32), max_new_tokens=2))
    other = get_config("phi3-mini-3.8b", smoke=True)
    om = tmodel.make_model(other)
    eng = ServeEngine(om, om.init(torch.Generator().manual_seed(0)), slots=1, max_len=64)
    with pytest.raises(ValueError, match="needs its frames"):
        eng.submit(Request(rid=0, prompt=np.ones(8, np.int32), max_new_tokens=2,
                           frames=torch.zeros(cfg.enc_len, cfg.d_model)))


def test_launcher_serves_whisper_contiguous_only(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    whisper-medium`` (smoke size) serves every request through plain
    admission, each with frames (enc_len, d_model) bf16 drawn from
    ``--seed``, in-flight and megastep; ``--kv-mode paged`` raises."""
    for mode in ("inflight", "megastep"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "6",
                    "--decode-mode", mode])
        out = capsys.readouterr().out
        assert "6 requests in" in out and "skipped=0 " in out and "'device_calls': 0" in out
    args = serve.parser().parse_args(["--device", "cpu", "--arch", ARCH, "--requests", "3"])
    cfg = get_config(ARCH, smoke=True)
    reqs, again = serve.make_requests(cfg, args), serve.make_requests(cfg, args)
    for r, r2 in zip(reqs, again):
        assert r.frames.dtype == torch.bfloat16
        assert tuple(r.frames.shape) == (cfg.enc_len, cfg.d_model)
        assert torch.equal(r.frames, r2.frames)
    assert not torch.equal(reqs[0].frames, reqs[1].frames)
    with pytest.raises(ValueError, match="attention decoder without meta tokens"):
        serve.build(serve.parser().parse_args(["--device", "cpu", "--arch", ARCH,
                                               "--kv-mode", "paged"]))
