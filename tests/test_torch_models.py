"""The port's decoder against the JAX package's, on the CPU, at smoke size.

Inputs come from numpy with a seed; the JAX parameters are carried across
with ``params_from_numpy``, so both packages compute the same function.
bf16 sums round in other orders in XLA and in PyTorch, so cross-framework
comparisons allow a few bf16 ulps (2^-8 relative each); comparisons inside
the port that the JAX package holds bit-exact are bit-exact here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import cache_batch_axes as jax_cache_batch_axes
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import params_from_numpy
from repro_torch.kernels.paged_attn import paged_attn_decode_plain
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.model import cache_batch_axes, make_model

# bf16 layer outputs: two ulps of the largest magnitude (XLA and PyTorch
# round intermediate products and sums at different places)
LAYER_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# attention outputs: bf16 scores and probabilities round once more each
ATTN_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
# values two bf16 layers deep (logits, the last layer's KV): within 0.03 of
# JAX's at O(1) magnitudes (the measured gap is one to two bf16 ulps)
DEEP_TOL = dict(rtol=0.02, atol=0.03)
# the port's plain paged attention against the JAX Pallas kernel: the
# kernel keeps f32 scores and accumulates flash-style; this is the JAX
# package's own gate for its kernel against its mirror
KERNEL_TOL = dict(rtol=0.05, atol=0.02)

SMOKE = "phi3-mini-3.8b"
# the attention-decoder families beside phi3-mini, at smoke size: QK-norm,
# windows and a tied, scaled embedding (gemma3); LayerNorm, GeLU and a
# window (starcoder2); LayerNorm and the parallel block (command-r); M-RoPE
# (qwen2-vl)
FAMILIES = ["gemma3-1b", "starcoder2-7b", "command-r-35b", "qwen2-vl-72b"]
# the MoE decoders and the hymba hybrid (their own tests are in
# test_torch_moe.py and test_torch_hymba.py)
NEW_FAMILIES = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"]
# the GQA case: 4 query heads on 2 KV heads (rep = 2)
GQA = dict(name="gqa-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab_size=512, attn_chunk=32, loss_chunk=32)
CONFIGS = ["smoke", "gqa"]


def _configs(which):
    if which == "smoke":
        return jax_get_config(SMOKE, smoke=True), get_config(SMOKE, smoke=True)
    return JaxArchConfig(**GQA), ArchConfig(**GQA)


def _pair(jcfg, cfg):
    """(jax cfg, port cfg, jax model, jax params, port model, port params)."""
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jm, jp, make_model(cfg), tp


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    return _pair(*_configs(request.param))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """``pair`` for a family's smoke config."""
    return _pair(jax_get_config(request.param, smoke=True),
                 get_config(request.param, smoke=True))


@pytest.fixture(scope="module", params=FAMILIES + NEW_FAMILIES)
def any_family(request):
    """``family``, the MoE and hymba smoke configs too."""
    return _pair(jax_get_config(request.param, smoke=True),
                 get_config(request.param, smoke=True))


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(jx, tx, tol):
    np.testing.assert_allclose(np.asarray(jx, np.float32), tx.float().numpy(), **tol)


def _equal(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx, np.float32), tx.float().numpy())


def _attn_params(pair_):
    jcfg, _, _, jp, _, tp = pair_
    return (jax.tree.map(lambda x: x[0], jp["blocks"]["attn"]),
            tp["blocks"][0]["attn"], jcfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, 3, 7, 128)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    _close(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5),
           layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5), LAYER_TOL)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(10)
    jx, tx = _bf16(rng, 3, 7, 144)
    jx, tx = jx + 0.5, tx + 0.5                 # a mean away from 0
    scale = (1 + 0.1 * rng.standard_normal(144)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(144)).astype(np.float32)
    want = jlayers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                             jx, 1e-5)
    got = layers.layernorm({"scale": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)}, tx, 1e-5)
    assert got.dtype == torch.bfloat16
    _close(want, got, LAYER_TOL)


@pytest.mark.parametrize("streams", ["distinct", "equal"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_mrope_matches_jax(theta, streams):
    """M-RoPE on (B, 3, S) position streams against JAX's; with three
    equal streams it is the port's own RoPE bit for bit."""
    rng = np.random.default_rng(11)
    jx, tx = _bf16(rng, 2, 9, 4, 16)
    pos = rng.integers(0, 300, (2, 3, 9)).astype(np.int32)
    if streams == "equal":
        pos[:, 1:] = pos[:, :1]
    got = layers.apply_mrope(tx, torch.from_numpy(pos), theta)
    _close(jlayers.apply_mrope(jx, jnp.asarray(pos), theta), got, LAYER_TOL)
    if streams == "equal":
        assert torch.equal(got, layers.apply_rope(tx, torch.from_numpy(pos[:, 0]), theta))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng, 2, 9, 4, 32)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    _close(jlayers.apply_rope(jx, jnp.asarray(pos), theta),
           layers.apply_rope(tx, torch.from_numpy(pos), theta), LAYER_TOL)


def test_swiglu_matches_jax(pair):
    _, _, _, jp, _, tp = pair
    jx, tx = _bf16(np.random.default_rng(2), 2, 5, 128)
    _close(jlayers.swiglu(jax.tree.map(lambda x: x[0], jp["blocks"]["mlp"]), jx),
           layers.swiglu(tp["blocks"][0]["mlp"], tx), LAYER_TOL)


def test_project_qkv_matches_jax(pair):
    jpa, tpa, cfg = _attn_params(pair)
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng, 2, 6, cfg.d_model)
    pos = rng.integers(0, 100, (2, 6)).astype(np.int32)
    args = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    jq = jattn._project_qkv(jpa, jx, *args, jnp.asarray(pos), "rope", 1e4)
    tq = attn._project_qkv(tpa, tx, *args, torch.from_numpy(pos), "rope", 1e4)
    for a, b in zip(jq, tq):
        _close(a, b, LAYER_TOL)


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (7, 0.0), (None, 30.0)])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_chunked_attention_matches_jax(h, kvh, window, softcap):
    rng = np.random.default_rng(4)
    jq, tq = _bf16(rng, 2, 20, h, 32)
    jk, tk = _bf16(rng, 2, 24, kvh, 32)
    jv, tv = _bf16(rng, 2, 24, kvh, 32)
    kw = dict(causal=True, window=window, softcap=softcap, chunk=8, q_offset=4)
    _close(jattn.chunked_attention(jq, jk, jv, **kw),
           attn.chunked_attention(tq, tk, tv, **kw), ATTN_TOL)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_masked_batch_attention_matches_jax(h, kvh, window):
    """Rows with different prefix lengths in one launch: prefix keys
    [0, plen) valid, then the segment at absolute positions plen + s."""
    rng = np.random.default_rng(5)
    b, s, pb = 3, 8, 16
    jq, tq = _bf16(rng, b, s, h, 32)
    jk, tk = _bf16(rng, b, pb + s, kvh, 32)
    jv, tv = _bf16(rng, b, pb + s, kvh, 32)
    plens = np.array([16, 5, 0], np.int32)
    qpos = plens[:, None] + np.arange(s)[None]
    kpos = np.concatenate([np.broadcast_to(np.arange(pb), (b, pb)), qpos], 1)
    kval = np.concatenate([np.arange(pb)[None] < plens[:, None],
                           np.ones((b, s), bool)], 1)
    want = jattn.masked_batch_attention(
        jq, jk, jv, q_pos=jnp.asarray(qpos), k_pos=jnp.asarray(kpos),
        k_valid=jnp.asarray(kval), window=window, chunk=4)
    got = attn.masked_batch_attention(
        tq, tk, tv, q_pos=torch.from_numpy(qpos), k_pos=torch.from_numpy(kpos),
        k_valid=torch.from_numpy(kval), window=window, chunk=4)
    _close(want, got, ATTN_TOL)


@pytest.mark.parametrize("vector_cur", [False, True])
def test_attn_decode_matches_jax(pair, vector_cur):
    jpa, tpa, cfg = _attn_params(pair)
    rng = np.random.default_rng(6)
    jx, tx = _bf16(rng, 3, 1, cfg.d_model)
    jck, tck = _bf16(rng, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    jcv, tcv = _bf16(rng, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    cur = np.array([5, 17, 30], np.int32) if vector_cur else 12
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim)
    jo, jk2, _ = jattn.attn_decode(jpa, jx, jck, jcv, jnp.asarray(cur), **kw)
    to, tk2, _ = attn.attn_decode(tpa, tx, tck, tcv, torch.as_tensor(cur), **kw)
    _close(jo, to, ATTN_TOL)
    _close(jk2, tk2, LAYER_TOL)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_fixture(cfg, seed=0, b=3, smax=64, pt=8, n_pages=10, tmax=32):
    """tests/test_paged_decode.py's fixture rebuilt with numpy: random pool
    and tails, block tables, prefix lengths (16, 8, 0) and tail lengths
    (5, 11, 7), plus the equivalent assembled contiguous cache.  Returns
    numpy arrays (float32 holding bf16 values)."""
    rng = np.random.default_rng(seed)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim

    def f(*s):
        return np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16), np.float32)

    fx = dict(pool_k=f(n_pages, pt, kvh, dh), pool_v=f(n_pages, pt, kvh, dh),
              tail_k=f(b, tmax, kvh, dh), tail_v=f(b, tmax, kvh, dh),
              bt=rng.integers(0, n_pages, (b, smax // pt)).astype(np.int32),
              plens=np.array([16, 8, 0], np.int32)[:b], x=f(b, 1, cfg.d_model))
    fx["curs"] = fx["plens"] + np.array([5, 11, 7], np.int32)[:b]
    for name, pool, tail in (("ck", "pool_k", "tail_k"), ("cv", "pool_v", "tail_v")):
        c = np.zeros((b, smax, kvh, dh), np.float32)
        for i in range(b):
            for j in range(fx["plens"][i] // pt):
                c[i, j * pt:(j + 1) * pt] = fx[pool][fx["bt"][i, j]]
            c[i, fx["plens"][i]:fx["plens"][i] + tmax] = fx[tail][i][: smax - fx["plens"][i]]
        fx[name] = c
    fx["smax"] = smax
    return fx


def _as(fx, framework):
    out = {}
    for k, v in fx.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
        elif framework == "jax":
            out[k] = jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
        else:
            t = torch.from_numpy(v.copy())
            out[k] = t.to(torch.bfloat16) if v.dtype == np.float32 else t
    return out


PAGED_CASES = [(None, 0.0), (24, 0.0), (None, 30.0), (24, 30.0)]


def _paged_call(mod, params, fx, cfg, window, softcap, **extra):
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
              rope_kind="rope", theta=1e4, window=window, softcap=softcap,
              smax=fx["smax"], **extra)
    return mod.paged_attn_decode(params, fx["x"], fx["pool_k"], fx["pool_v"], fx["bt"],
                                 fx["tail_k"], fx["tail_v"], fx["plens"], fx["curs"], **kw)


@pytest.mark.parametrize("window,softcap", PAGED_CASES)
def test_paged_plain_matches_jax_mirror_and_kernel(pair, window, softcap):
    """The port's paged decode (plain version on the CPU) against the JAX
    mirror and against the JAX Pallas kernel in interpret mode; the new KV
    lands in the tail with the same bits."""
    jpa, tpa, cfg = _attn_params(pair)
    fx = _paged_fixture(cfg, seed=3)
    jfx, tfx = _as(fx, "jax"), _as(fx, "torch")
    out, tk, tv = _paged_call(attn, tpa, tfx, cfg, window, softcap)
    out_m, tkm, tvm = _paged_call(jattn, jpa, jfx, cfg, window, softcap)
    out_k, tkk, _ = _paged_call(jattn, jpa, jfx, cfg, window, softcap,
                                use_kernel=True, interpret=True)
    _close(out_m, out, ATTN_TOL)
    _close(out_k, out, KERNEL_TOL)
    _close(tkm, tk, LAYER_TOL)
    np.testing.assert_array_equal(np.asarray(tkm, np.float32), np.asarray(tkk, np.float32))


@pytest.mark.parametrize("window,softcap", PAGED_CASES)
def test_paged_plain_bit_identical_to_contiguous(pair, window, softcap):
    """Inside the port, as inside the JAX package: paged decode (plain)
    equals ``attn_decode`` on the assembled contiguous cache bit for bit,
    outputs and the new KV rows."""
    _, tpa, cfg = _attn_params(pair)
    fx = _as(_paged_fixture(cfg, seed=1), "torch")
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
              rope_kind="rope", theta=1e4, window=window, softcap=softcap)
    out_c, ck2, cv2 = attn.attn_decode(tpa, fx["x"], fx["ck"], fx["cv"], fx["curs"], **kw)
    out_p, tk2, tv2 = _paged_call(attn, tpa, fx, cfg, window, softcap)
    assert torch.equal(out_c, out_p)
    for i in range(3):
        cur, plen = int(fx["curs"][i]), int(fx["plens"][i])
        assert torch.equal(ck2[i, cur], tk2[i, cur - plen])
        assert torch.equal(cv2[i, cur], tv2[i, cur - plen])


def test_paged_plain_defaults_to_the_block_table_width():
    """Without ``smax`` the plain version's view is NP·page_tokens lanes,
    the same function as any wider view (masked lanes add exact zeros)."""
    cfg = get_config(SMOKE, smoke=True)
    fx = _as(_paged_fixture(cfg, seed=2), "torch")
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((3, cfg.n_heads, cfg.head_dim))
                         .astype(np.float32)).to(torch.bfloat16)
    args = (q, fx["pool_k"], fx["pool_v"], fx["bt"], fx["tail_k"], fx["tail_v"],
            fx["plens"], fx["curs"])
    a = paged_attn_decode_plain(*args)
    b = paged_attn_decode_plain(*args, smax=fx["smax"] + 16)
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0, atol=2 ** -8)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _assert_same_greedy(jl, tl):
    """Greedy tokens equal, except where JAX's own top-2 logits lie within
    the logit tolerance: logits are rounded to bf16, so random weights
    leave one-ulp ties that either framework's rounding may break."""
    jl, tl = np.asarray(jl), tl.numpy()
    jt, tt = jl.argmax(-1), tl.argmax(-1)
    rows = np.arange(len(jt))
    margin = jl[rows, jt] - jl[rows, tt]
    assert np.all((jt == tt) | (margin <= DEEP_TOL["atol"])), (jt, tt, margin)


def test_prefill_and_teacher_forced_decode_match_jax(pair):
    """``prefill`` logits and KV, then six teacher-forced ``decode_step``s
    at per-row lengths: logits within DEEP_TOL and greedy tokens equal (up
    to bf16 ties)."""
    _check_prefill_and_decode(pair)


def test_family_prefill_and_teacher_forced_decode_match_jax(family):
    """The same for each family's smoke config: gemma3's windows of 16 and
    starcoder2's of 32 bind at these lengths (prompts of 24, rows decoding
    to 30).  For M-RoPE also a prefill with three distinct position streams
    given in the batch."""
    _check_prefill_and_decode(family)
    jcfg, cfg, jm, jp, tm, tp = family
    if cfg.rope_kind == "mrope":
        rng = np.random.default_rng(12)
        toks = rng.integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
        pos = np.sort(rng.integers(0, 40, (2, 3, 20)), axis=-1).astype(np.int32)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "positions": torch.from_numpy(pos)})
        _close(jl, tl, DEEP_TOL)
        _close(jc["k"][:2], tc["k"][:2], DEEP_TOL)
        _assert_same_greedy(jl, tl)


def _check_prefill_and_decode(pair_, rows=3, kv_layers=2):
    """Prefill of ``rows`` 24-token prompts, then six teacher-forced decode
    steps at per-row lengths (row 1 rewinds to 20), against JAX; the KV of
    the first ``kv_layers`` layers is compared.  A hymba cache holds the
    meta tokens' positions before the prompt and carries the Mamba state
    from the prefill."""
    jcfg, cfg, jm, jp, tm, tp = pair_
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (rows, 24)).astype(np.int32)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(jl, tl, DEEP_TOL)
    # the KV of the first two layers, at most two bf16 layers deep (all of
    # it for the two-layer configs; gemma3-smoke has three, and each block
    # given the same input agrees with JAX's to one bf16 ulp)
    _close(jc["k"][:kv_layers], tc["k"][:kv_layers], DEEP_TOL)
    _assert_same_greedy(jl, tl)

    s = jc["k"].shape[2]                          # 24 + meta tokens
    jcache = jm.init_cache(rows, 40)
    tcache = tm.init_cache(rows, 40, device="cpu")
    for k in ("k", "v"):
        jcache[k] = jcache[k].at[:, :, :s].set(jc[k])
        tcache[k][:, :, :s] = tc[k]
    if "mamba" in jc:
        jcache["mamba"] = jc["mamba"]
        tcache["mamba"] = tc["mamba"]
    cur = np.array([24, 20, 24, 22][:rows], np.int32)   # row 1 rewinds: unequal lengths
    feed = rng.integers(1, cfg.vocab_size, (6, rows, 1)).astype(np.int32)
    for step in range(6):
        jl, jcache = jdecode(jp, jnp.asarray(feed[step]), jcache, jnp.asarray(cur))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(feed[step]), tcache,
                                    torch.from_numpy(cur))
        _close(jl, tl, DEEP_TOL)
        _assert_same_greedy(jl, tl)
        cur = cur + 1


def test_params_carry_exactly(pair):
    """``params_from_numpy`` keeps every JAX value: layer l of a stacked
    block leaf, bf16 weights and f32 norm scales."""
    _, cfg, _, jp, _, tp = pair
    for l in range(cfg.n_layers):
        np.testing.assert_array_equal(
            np.asarray(jp["blocks"]["attn"]["wq"][l], np.float32),
            tp["blocks"][l]["attn"]["wq"].float().numpy())
    assert tp["head"]["out_norm"]["scale"].dtype == torch.float32
    assert tp["head"]["embed"].dtype == torch.bfloat16
    n = sum(x.numel() for x in tp.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jp))


def test_family_params_carry_exactly(any_family):
    """Every leaf of the JAX parameters arrives with its value and its JAX
    dtype: f32 stays f32 (norm parameters, LayerNorm's bias too, the MoE
    router, Mamba's ``dt_bias``, ``a_log`` and ``d_skip``, hymba's fuse
    vectors), bf16 stays bf16; top-level leaves (hymba's ``meta``) too."""
    _, cfg, _, jp, _, tp = any_family
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    f32 = set()
    for path, leaf in leaves:
        names = [k.key for k in path]
        layers_ = range(cfg.n_layers) if names[0] == "blocks" else [None]
        for l in layers_:
            t = tp[names[0]] if l is None else tp[names[0]][l]
            for name in names[1:]:
                t = t[name]
            want = np.asarray(leaf if l is None else leaf[l])
            assert t.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[want.dtype.name], names
            np.testing.assert_array_equal(want.astype(np.float32), t.float().numpy(),
                                          err_msg=str(names))
            if t.dtype == torch.float32:
                f32.add(names[-1])
    assert {"scale"} <= f32
    if cfg.norm == "ln":
        assert tp["blocks"][0]["ln1"]["bias"].dtype == torch.float32
    if cfg.ffn == "moe":
        assert "router" in f32
    if cfg.mixer == "hymba":
        assert {"dt_bias", "a_log", "d_skip", "fuse_a", "fuse_m"} <= f32
        assert tp["meta"].shape == (cfg.meta_tokens, cfg.d_model)
    assert sum(x.numel() for x in tp.parameters()) == sum(x.size for x in
                                                          jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", [SMOKE] + FAMILIES + NEW_FAMILIES)
def test_init_draws_the_published_shapes_on_the_generators_device(arch):
    """The port's init draws as many parameters as ``param_count`` says,
    norms per family included (and experts, routers, Mamba branches and
    meta tokens), as many as the JAX init's leaves hold, each leaf of its
    JAX shape and dtype; the cache's batch axes are JAX's."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    params = make_model(cfg).init(torch.Generator(device="cpu").manual_seed(0))
    n = sum(x.numel() for x in params.parameters())
    jshapes = jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0))
    assert n == cfg.param_count() == sum(x.size for x in jax.tree.leaves(jshapes))
    want = {jax.tree_util.keystr(path): (tuple(leaf.shape[1:] if path[0].key == "blocks"
                                               else leaf.shape), leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {}
    for name, t in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            if parts[1] != "1":
                continue
            parts = parts[:1] + parts[2:]
        got["".join(f"['{p}']" for p in parts)] = (tuple(t.shape),
                                                   str(t.dtype).removeprefix("torch."))
    assert got == want
    assert cache_batch_axes(cfg) == jax_cache_batch_axes(jcfg)


def test_unported_archs_and_families_raise():
    """Every architecture of the JAX package resolves (xLSTM and the Whisper
    encoder-decoder among them, the last two ported) and builds a model and
    its cache axes; a name or a mixer the JAX package does not have raises."""
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs

    assert sorted(list_archs()) == sorted(jax_list_archs())
    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        make_model(cfg)
        assert cache_batch_axes(cfg) == jax_cache_batch_axes(jax_get_config(arch, smoke=True))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    base = dict(family="ssm", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab_size=64)
    with pytest.raises(ValueError, match="unknown mixer"):
        make_model(ArchConfig(name="rwkv", mixer="rwkv", **base))
