"""The port's xLSTM (mLSTM and sLSTM groups) against the JAX package's, on
the CPU, at smoke size; and the engine's serve of it.

The mLSTM chunk, ``mlstm_apply`` and ``mlstm_decode``, the sLSTM, the
model's prefill and teacher-forced decode, on the same numpy-seeded inputs
and the JAX parameters carried by ``params_from_numpy``.  The JAX engine
cannot serve xLSTM (its per-slot merge takes the batch axis of every leaf to
be 1, and its install copies no mLSTM or sLSTM leaf; ROADMAP Queue 3), so
the port's ``ServeEngine`` (contiguous, in-flight, megastep and round-robin)
is held against the JAX *model* path: ``prefill`` of each prompt, then
``decode_step`` at B = 1.  Inside the port, exactly: megastep and
round-robin give the in-flight tokens, a frozen row's state stays bit-equal
through a window, and the window graph's warm-up (``k_limit = 0``) changes
no state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.model import cache_batch_axes as jax_cache_batch_axes
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.configs.base import xlstm_ffn_dim
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models.model import cache_batch_axes
from repro_torch.serving.engine import Request, ServeEngine, megastep_decode, state_leaves
from test_torch_models import DEEP_TOL, LAYER_TOL, _assert_same_greedy, _bf16, _close, _pair
from test_torch_serving import _drive, _prompts, _summary

ARCH = "xlstm-1.3b"
# f32 recurrences on equal f32 inputs (the mLSTM chunk; the states after a
# bf16 layer whose projections round alike): the frameworks sum in other
# orders and take exp and log-sigmoid from other libraries, so within 1e-5
# relative, and 1e-5 of the leaf's largest magnitude where an element nears 0
F32_REL = 1e-5
# the mLSTM state inside the model, where the block's input is a bf16 hidden
# state that the frameworks round differently: four bf16 ulps (2^-6) of the
# leaf's largest magnitude
MODEL_STATE_REL = 2 ** -6
# logits of the JAX model path that the port's greedy choice may differ from
# (the model tests' logit tolerance, DEEP_TOL's atol)
TIE = DEEP_TOL["atol"]


def _f32_close(want, got, rel=F32_REL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def xlstm():
    """(jax cfg, port cfg, jax model, jax params, port model, port params)."""
    return _pair(jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True))


def _mlstm(pair_, j=0):
    """Group 0's mLSTM block ``j``: JAX's cell parameters and the port's."""
    _, cfg, _, jp, _, tp = pair_
    return (jax.tree.map(lambda x: x[0, j], jp["blocks"]["mlstm"]["cell"]),
            tp["blocks"][0]["mlstm"][j]["cell"], cfg)


def _close_mlstm_state(js, ts, rel=F32_REL):
    for n in ("c", "n", "m"):
        _f32_close(js[n], ts[n], rel)
        assert ts[n].dtype == torch.float32, n
    _close(js["conv"], ts["conv"], LAYER_TOL)
    assert ts["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,pad", [(16, 0), (16, 7), (32, 0)])
def test_mlstm_chunk_matches_jax(length, pad):
    """One stabilized chunk on equal f32 inputs from a carried state, within
    F32_REL of JAX's: h and the state at the chunk's end.  With ``pad`` the
    chunk's last steps carry the padding fill (log input gate -1e30, log
    forget gate 0): the state then equals that of the unpadded steps."""
    rng = np.random.default_rng(length + pad)
    b, h, dh = 2, 3, 8
    q, k, v = (rng.standard_normal((b, h, length, dh)).astype(np.float32) for _ in range(3))
    lf = -np.abs(rng.standard_normal((b, h, length))).astype(np.float32)
    li = rng.standard_normal((b, h, length)).astype(np.float32)
    if pad:
        for t in (q, k, v):
            t[:, :, length - pad:] = 0
        lf[..., length - pad:] = 0
        li[..., length - pad:] = -1e30
    state = (rng.standard_normal((b, h, dh, dh)).astype(np.float32),
             rng.standard_normal((b, h, dh)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    jh, jst = jssm._mlstm_chunk(*(jnp.asarray(x) for x in (q, k, v, lf, li)),
                                tuple(jnp.asarray(x) for x in state))
    th, tst = ssm._mlstm_chunk(*(torch.from_numpy(x) for x in (q, k, v, lf, li)),
                               tuple(torch.from_numpy(x) for x in state))
    _f32_close(jh, th)
    for a, b_ in zip(jst, tst):
        _f32_close(a, b_)
    if pad:
        n = length - pad
        _, short = ssm._mlstm_chunk(*(torch.from_numpy(x[..., :n, :] if x.ndim == 4
                                                       else x[..., :n])
                                      for x in (q, k, v, lf, li)),
                                    tuple(torch.from_numpy(x) for x in state))
        for a, b_ in zip(short, tst):
            _f32_close(a, b_, rel=1e-6)


@pytest.mark.parametrize("length", [9, 16, 37])
def test_mlstm_apply_and_decode_match_jax(xlstm, length):
    """``mlstm_apply`` with S below, at and above the chunk (16; 37 is not a
    multiple: the last chunk padded): the output within LAYER_TOL, the
    returned state (``c``, ``n``, ``m`` f32) within F32_REL, ``conv`` the
    last three positions of the conv input; then five ``mlstm_decode``
    steps from that state, held the same way.  The state is equal (to f32
    rounding) whether or not the prompt is padded: S = 9 at chunk 16 against
    chunk 9."""
    jpm, tpm, cfg = _mlstm(xlstm)
    rng = np.random.default_rng(length)
    jx, tx = _bf16(rng, 2, length, cfg.d_model)
    kw = dict(n_heads=cfg.n_heads, chunk=cfg.ssm_chunk, return_state=True)
    jy, js = jssm.mlstm_apply(jpm, jx, **kw)
    ty, ts = ssm.mlstm_apply(tpm, tx, **kw)
    _close(jy, ty, LAYER_TOL)
    _close_mlstm_state(js, ts)
    di = tpm["wq"].shape[0]
    assert torch.equal(ts["conv"], (tx @ tpm["w_up"])[:, -3:, :di])
    if length % cfg.ssm_chunk:
        _, whole = ssm.mlstm_apply(tpm, tx, **{**kw, "chunk": length})
        for n in ("c", "n", "m"):
            _f32_close(whole[n], ts[n], rel=1e-6)
    for _ in range(5):
        jx, tx = _bf16(rng, 2, 1, cfg.d_model)
        jy, js = jssm.mlstm_decode(jpm, jx, js, n_heads=cfg.n_heads)
        ty, ts = ssm.mlstm_decode(tpm, tx, ts, n_heads=cfg.n_heads)
        _close(jy, ty, LAYER_TOL)
        _close_mlstm_state(js, ts)


@pytest.mark.parametrize("warm", [False, True])
def test_slstm_apply_matches_jax(xlstm, warm):
    """The sLSTM over 12 positions, cold and from a carried state (the
    state after 7 other positions): the output within LAYER_TOL, the state
    (``c``, ``n``, ``h``, ``m``, f32) within F32_REL; then one position at a
    time (decode) from that state."""
    _, cfg, _, jp, _, tp = xlstm
    jpc = jax.tree.map(lambda x: x[0], jp["blocks"]["slstm"]["cell"])
    tpc = tp["blocks"][0]["slstm"]["cell"]
    rng = np.random.default_rng(11 + warm)
    kw = dict(n_heads=cfg.n_heads)
    js = ts = None
    if warm:
        jx, tx = _bf16(rng, 2, 7, cfg.d_model)
        _, js = jssm.slstm_apply(jpc, jx, **kw)
        _, ts = ssm.slstm_apply(tpc, tx, **kw)
    for s in (12, 1, 1):
        jx, tx = _bf16(rng, 2, s, cfg.d_model)
        jy, js = jssm.slstm_apply(jpc, jx, state=js, **kw)
        ty, ts = ssm.slstm_apply(tpc, tx, state=ts, **kw)
        _close(jy, ty, LAYER_TOL)
        assert ty.dtype == torch.bfloat16
        for n in ("c", "n", "h", "m"):
            _f32_close(js[n], ts[n])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."))


def test_xlstm_prefill_and_teacher_forced_decode_match_jax(xlstm):
    """``prefill`` of three 24-token prompts (the chunk of 16 padded once),
    then six teacher-forced ``decode_step``s from its state: logits within
    DEEP_TOL and greedy tokens equal up to bf16 ties; the first mLSTM
    block's state within MODEL_STATE_REL.  The cache has JAX's tree, shapes,
    dtypes and batch axes (the mLSTM leaves' batch on axis 2)."""
    jcfg, cfg, jm, jp, tm, tp = xlstm
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (3, 24)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(jl, tl, DEEP_TOL)
    _assert_same_greedy(jl, tl)
    _close_mlstm_state(jax.tree.map(lambda x: x[0, 0], jc["mlstm"]),
                       {n: x[0, 0] for n, x in tc["mlstm"].items()}, MODEL_STATE_REL)
    assert cache_batch_axes(cfg) == jax_cache_batch_axes(jcfg)
    assert _tree_np(tc) == jax.tree.map(lambda x: (x.shape, x.dtype.name), jc)
    assert _tree_np(tm.init_cache(3, 40, device="cpu")) == \
        jax.tree.map(lambda x: (x.shape, x.dtype.name), jm.init_cache(3, 40))
    jdecode = jax.jit(jm.decode_step)
    feed = rng.integers(1, cfg.vocab_size, (6, 3, 1)).astype(np.int32)
    cur = np.array([24, 20, 24], np.int32)          # position-free: not read
    for step in range(6):
        jl, jc = jdecode(jp, jnp.asarray(feed[step]), jc, jnp.asarray(cur))
        tl, tc = tm.decode_step(tp, torch.from_numpy(feed[step]), tc,
                                torch.from_numpy(cur))
        _close(jl, tl, DEEP_TOL)
        _assert_same_greedy(jl, tl)
        cur = cur + 1


def test_xlstm_params_carry_and_init_draw_the_jax_tree(xlstm):
    """``params_from_numpy`` splits the JAX groups (leading n_groups axis)
    and their mLSTM blocks (a second g-1 axis) into the port's tree, each
    leaf with its JAX value and dtype (``if_bias``, ``skip_scale``,
    ``gate_bias`` and the norm scales f32); the port's init draws the same
    shapes and dtypes, as many parameters as ``param_count`` says."""
    jcfg, cfg, jm, jp, tm, tp = xlstm
    g = cfg.scan_group
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = [k.key for k in path]
        arr = np.asarray(leaf)
        if names[0] == "blocks":
            idx = ([(gi, j) for gi in range(arr.shape[0]) for j in range(g - 1)]
                   if names[1] == "mlstm" else [(gi,) for gi in range(arr.shape[0])])
        else:
            idx = [()]
        for ix in idx:
            t = tp[names[0]]
            if names[0] == "blocks":
                t = t[ix[0]][names[1]]
                t = t[ix[1]] if len(ix) == 2 else t
                rest = names[2:]
            else:
                rest = names[1:]
            for name in rest:
                t = t[name]
            want = arr[ix]
            assert str(t.dtype).removeprefix("torch.") == want.dtype.name, names
            np.testing.assert_array_equal(want.astype(np.float32), t.float().numpy(),
                                          err_msg=str(names))
    assert tp["blocks"][0]["mlstm"][0]["cell"]["if_bias"].dtype == torch.float32
    assert tp["blocks"][0]["slstm"]["cell"]["gate_bias"].dtype == torch.float32
    n_jax = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(x.numel() for x in tp.parameters()) == n_jax
    fresh = tm.init(torch.Generator(device="cpu").manual_seed(0))
    assert sum(x.numel() for x in fresh.parameters()) == cfg.param_count() == n_jax
    assert {n: (tuple(x.shape), x.dtype) for n, x in fresh.named_parameters()} == \
        {n: (tuple(x.shape), x.dtype) for n, x in tp.named_parameters()}


def test_xlstm_full_width_config_and_count():
    """xlstm-1.3b at its published widths: 48 blocks in 6 groups of 7 mLSTM
    and 1 sLSTM, d_model 2048, 4 heads, inner width 4096 (mLSTM Dh 1024),
    vocab 50304.  ``param_count`` is every leaf the JAX init makes (its
    shapes traced, not drawn): 3.574B, where JAX's analytic count, 3.572B,
    leaves out the norms, the gate biases and the skip scale and does not
    round the sLSTM MLP's width (2730 against the 2816 the model uses)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert xlstm_ffn_dim(cfg) == 2816
    shapes = jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0))
    assert shapes["blocks"]["mlstm"]["cell"]["wq"].shape == (6, 7, 4096, 4096)
    assert cfg.param_count() == sum(x.size for x in jax.tree.leaves(shapes))
    assert round(cfg.param_count() / 1e9, 3) == 3.574
    assert round(jcfg.param_count() / 1e9, 3) == 3.572


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def jax_model_streams(jm, jp, cfg, prompts, max_new, frames=None, max_len=128):
    """Each request through the JAX model path: ``prefill`` of its prompt
    (and frames), then greedy ``decode_step``s at B = 1.  Returns, per
    request, (tokens, the logits each token was chosen from)."""
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    out = []
    for i, p in enumerate(prompts):
        batch = {"tokens": jnp.asarray(p[None])}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames[i][None], jnp.bfloat16)
        logits, pc = prefill(jp, batch)
        if "k" in pc:                         # the encoder-decoder's caches
            cache = jm.init_cache(1, max_len)
            cache = {n: cache[n].at[:, :, :pc[n].shape[2]].set(pc[n]) for n in cache}
        else:
            cache = pc
        toks, lgs = [], []
        for j in range(max_new):
            lg = np.asarray(logits[0])
            toks.append(int(lg.argmax()))
            lgs.append(lg)
            if j + 1 < max_new:
                logits, cache = decode(jp, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                       jnp.int32(len(p) + j))
        out.append((toks, lgs))
    return out


def assert_streams_equal_or_tied(got, ref):
    """Every request served in full; each stream equal to the JAX model
    path's but where, at the first step the two differ, JAX's logits put the
    two tokens within TIE (a bf16 tie that either framework may break; past
    it the streams go their own ways).  Returns the split requests."""
    assert sorted(got) == list(range(len(ref)))
    split = []
    for rid, (toks, lgs) in enumerate(ref):
        assert len(got[rid]) == len(toks)
        if got[rid] != toks:
            j = next(i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b)
            gap = float(lgs[j][toks[j]] - lgs[j][got[rid][j]])
            assert gap <= TIE, (rid, j, toks[j], got[rid][j], gap)
            split.append(rid)
    return split


def serve_contiguous(stack, prompts, frames=None, **engine_kw):
    """The port's contiguous engine over ``prompts`` (the launcher's prefix
    cache and pool, which these families leave unused), summarised."""
    return _summary(_drive(True, stack, prompts, kv_mode="contiguous", frames=frames,
                           **engine_kw))


def assert_plain_admission(out, prompts):
    """Every prompt prefilled whole, the prefix cache never asked."""
    assert sorted(out["prefill"]) == [(i, 0, len(p)) for i, p in enumerate(prompts)]
    assert out["cache"]["hits"] + out["cache"]["misses"] == 0


@pytest.fixture(scope="module")
def reference(xlstm):
    """The JAX model path's streams for the engine tests' prompts."""
    jcfg, _, jm, jp, _, _ = xlstm
    prompts = _prompts(jcfg)
    return prompts, jax_model_streams(jm, jp, jcfg, prompts, 6)


@pytest.mark.parametrize("decode_mode", ["inflight", "megastep", "roundrobin"])
def test_xlstm_engine_matches_jax_model_path(xlstm, reference, decode_mode):
    """xlstm-smoke through the port's contiguous engine (ten prompts of
    37-45 tokens, three slots, six new tokens each) gives the JAX model
    path's greedy streams, or splits from one at a bf16 tie; every prompt
    prefilled whole (no prefix cache call)."""
    _, cfg, _, _, tm, tp = xlstm
    prompts, ref = reference
    out = serve_contiguous((cfg, tm, tp), prompts, decode_mode=decode_mode)
    assert_streams_equal_or_tied(out["tokens"], ref)
    assert_plain_admission(out, prompts)
    if decode_mode == "megastep":
        assert out["stats"]["megastep_windows"] > 0


def test_xlstm_megastep_and_roundrobin_equal_inflight(xlstm):
    """Inside the port, exactly: megastep windows (rows past ``k_limit`` and
    retired rows frozen) and round-robin decode (rows above the minimum
    frozen) give the in-flight engine's tokens, token for token, and the
    same prefill split; megastep also its finish order and ticks."""
    _, cfg, _, _, tm, tp = xlstm
    prompts = _prompts(cfg, seed=2)
    runs = {m: serve_contiguous((cfg, tm, tp), prompts, decode_mode=m, max_new=9)
            for m in ("inflight", "megastep", "roundrobin")}
    for m in ("megastep", "roundrobin"):
        assert runs[m]["tokens"] == runs["inflight"]["tokens"], m
        assert sorted(runs[m]["prefill"]) == sorted(runs["inflight"]["prefill"]), m
    assert runs["megastep"]["order"] == runs["inflight"]["order"]
    assert runs["megastep"]["stats"]["ticks"] == runs["inflight"]["stats"]["ticks"]
    assert runs["megastep"]["stats"]["megastep_windows"] > 0
    assert runs["roundrobin"]["stats"]["ticks"] > runs["inflight"]["stats"]["ticks"]


def _leaves(cache):
    return {(part, n): x for part in ("mlstm", "slstm") for n, x in cache[part].items()}


def test_frozen_row_keeps_its_xlstm_state(xlstm):
    """The port's form of ``test_cache_batch_axes_freezes_every_family``:
    from a random state, a two-step window with row 1 not live leaves every
    mLSTM and sLSTM leaf of row 1 bit-equal (the mLSTM leaves' batch on axis
    2), emits nothing for it and keeps its cur_len and last token; row 0
    emits the tokens of the plain decode loop and ends in its state.  With
    ``k_limit`` 1 of 2, every row keeps the state after one step."""
    _, cfg, _, _, tm, tp = xlstm
    axes = cache_batch_axes(cfg)
    leaves = state_leaves(axes)
    rng = np.random.default_rng(3)
    cache0 = tm.init_cache(2, 32, device="cpu")
    for (part, n), x in _leaves(cache0).items():
        r = rng.standard_normal(tuple(x.shape)).astype(np.float32)
        x.copy_(torch.from_numpy(np.abs(r) + 0.5 if n == "n" else r))
    last = torch.tensor([[5], [9]], dtype=torch.int32)
    cur = torch.tensor([3, 4], dtype=torch.int32)

    def copy(cache):
        return {part: {n: x.clone() for n, x in cache[part].items()} for part in cache}

    def window(cache, k_limit, live=(True, False)):
        return megastep_decode(tm.decode_step, tp, last, cache, cur, torch.tensor(live),
                               torch.tensor([6, 6], dtype=torch.int32), eos=-1,
                               max_len=32, steps=2, k_limit=torch.tensor(k_limit),
                               park=torch.zeros(2, dtype=torch.int32), state=leaves)

    cache = copy(cache0)
    lt, cu, _, toks, emits = window(cache, 2)
    for (part, n), x in _leaves(cache).items():
        ax = axes[part][n]
        assert torch.equal(x.select(ax, 1), _leaves(cache0)[part, n].select(ax, 1)), n
        assert not torch.equal(x.select(ax, 0), _leaves(cache0)[part, n].select(ax, 0)), n
    assert not emits[:, 1].any() and (toks[:, 1] == -1).all()
    assert int(cu[1]) == 4 and int(lt[1, 0]) == 9 and int(cu[0]) == 5
    loop, lt_l = copy(cache0), last
    for i in range(2):
        logits, loop = tm.decode_step(tp, lt_l, loop, torch.tensor([3 + i, 0]))
        lt_l = torch.argmax(logits, -1).to(torch.int32)[:, None]
        assert int(toks[i, 0]) == int(lt_l[0, 0])
    for (part, n), x in _leaves(cache).items():
        ax = axes[part][n]
        assert torch.equal(x.select(ax, 0), _leaves(loop)[part, n].select(ax, 0)), n

    one = copy(cache0)
    _, cu1, _, _, emits1 = window(one, 1, live=(True, True))
    _, step = tm.decode_step(tp, last, copy(cache0), cur)
    assert emits1[0].all() and not emits1[1].any()
    np.testing.assert_array_equal(cu1.numpy(), [4, 5])
    for key, x in _leaves(one).items():
        assert torch.equal(x, _leaves(step)[key]), key


def test_window_warm_up_leaves_the_xlstm_state_bit_equal(xlstm):
    """``capture_window``'s warm-up runs the window body on the engine's
    state with ``k_limit = 0``; run eagerly on the CPU mid-serve (two live
    rows, a retired one's idle slot), it leaves every mLSTM and sLSTM leaf
    bit-equal and emits nothing."""
    _, cfg, _, _, tm, tp = xlstm
    eng = ServeEngine(tm, tp, slots=3, max_len=128)
    for i, (p, n) in enumerate(zip(_prompts(cfg, n=3), (2, 8, 8))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    for _ in range(3):
        eng.step()                    # request 0 has retired: its slot is idle
    assert len(eng.active) == 2 and len(eng._free_slots) == 1
    before = {k: x.clone() for k, x in _leaves(eng.cache).items()}
    out = eng._window_body(eng._tensor(eng._window_inputs(0)), 4)
    for k, x in _leaves(eng.cache).items():
        assert torch.equal(x, before[k]), k
    assert not out[4:8].any() and (out[:4] == -1).all()


def test_launcher_serves_xlstm_contiguous_only(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch xlstm-1.3b``
    (smoke size) serves every request through plain admission, the prefix
    cache unused, in each decode mode; ``--kv-mode paged`` raises."""
    for mode in ("inflight", "megastep", "roundrobin"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "6",
                    "--decode-mode", mode])
        out = capsys.readouterr().out
        assert "6 requests in" in out and "skipped=0 " in out and "'device_calls': 0" in out
    with pytest.raises(ValueError, match="attention decoder without meta tokens"):
        serve.build(serve.parser().parse_args(["--device", "cpu", "--arch", ARCH,
                                               "--kv-mode", "paged"]))
