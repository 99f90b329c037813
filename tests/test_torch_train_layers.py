"""The port's training pieces against the JAX package's, on the CPU: the
norms' custom VJPs, the chunked cross-entropy, chunked attention's
gradients, AdamW and its schedule, the synthetic data and the training half
of ``launch/elastic.py``.

Inputs are numpy arrays from a seed, fed to both packages.  Tolerances are
stated in ulps: a bf16 ulp of a leaf's largest magnitude m is
``2^(floor(log2 m) - 7)`` (``_ulp``), an f32 ulp an int32 step of the bits.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.launch import elastic as jelastic
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data.synthetic import Prefetcher, SyntheticLM
from repro_torch.launch import elastic
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.model import make_model
from repro_torch.train import optimizer as opt

# cross-framework gradients of one layer: XLA may keep an f32 intermediate
# of a bf16 expression where PyTorch rounds it, so an element may differ by
# a bf16 ulp; held in ulps of the leaf's largest magnitude
NORM_ULPS = 1
XENT_ULPS = 2           # the loss gradient through one bf16 matmul
ATTN_ULPS = 4           # scores and probabilities round once more each
LOSS_RTOL = 2 ** -16    # the f32 mean NLL of bf16 logits


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: they take the same time
    with 1 as with 8 alone, and under several pytest workers sharing the
    cores, 8 spinning threads per worker slowed them tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(m: float) -> float:
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_ulps(want, got, ulps, what=""):
    """|got - want| <= ``ulps`` bf16 ulps of want's largest magnitude."""
    w, g = _np(want), _np(got)
    assert w.shape == g.shape, what
    gap = np.abs(w - g).max() / _ulp(np.abs(w).max())
    assert gap <= ulps, f"{what}: {gap:.2f} bf16 ulps > {ulps}"


def _f32_ulps(want, got) -> int:
    """The largest distance in f32 ulps (steps of the int32 bits) between
    same-signed f32 arrays."""
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _bf16(rng, *shape, shift=0.0):
    x = (rng.standard_normal(shape) + shift).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_vjp_matches_jax(kind):
    """The norm's forward and its custom VJP (x, scale and bias cotangents)
    against ``jax.vjp`` of the JAX norm, in bf16, within NORM_ULPS; the
    residuals saved for backward are bf16 (B, S, D) values and f32 row
    statistics, never an f32 copy of x; without grad the forward is the
    same bits."""
    rng = np.random.default_rng(30)
    d = 144
    jx, tx = _bf16(rng, 3, 7, d, shift=0.5 if kind == "ln" else 0.0)
    jg, tg = _bf16(rng, 3, 7, d)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    names = ["scale"] + (["bias"] if kind == "ln" else [])
    vals = {"scale": scale, "bias": bias}
    jfn, tfn = ((jlayers.rmsnorm, layers.rmsnorm) if kind == "rms"
                else (jlayers.layernorm, layers.layernorm))

    def jax_norm(x, *ps):
        return jfn(dict(zip(names, ps)), x, 1e-5)

    want, vjp = jax.vjp(jax_norm, jx, *(jnp.asarray(vals[n]) for n in names))
    want_grads = vjp(jg)

    tx.requires_grad_(True)
    tps = {n: torch.from_numpy(vals[n]).requires_grad_(True) for n in names}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        got = tfn(tps, tx, 1e-5)
    got.backward(tg)
    assert got.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    _assert_ulps(want, got, NORM_ULPS, "y")
    for name, w, t in zip(["x"] + names, want_grads, [tx] + [tps[n] for n in names]):
        assert t.grad.dtype == t.dtype
        _assert_ulps(w, t.grad, NORM_ULPS, name)
    assert not [t for t in saved if t.dtype == torch.float32 and t.shape == tx.shape]
    with torch.no_grad():
        assert torch.equal(tfn(tps, tx, 1e-5), got)


# ---------------------------------------------------------------------------
# loss and attention
# ---------------------------------------------------------------------------

def test_chunked_softmax_xent_matches_jax():
    """The chunked mean NLL (S = 50 in chunks of 16: three recomputed
    chunks and a remainder of 2) and its gradients in h and in the vocab
    matrix, against ``jax.value_and_grad`` of the JAX one."""
    rng = np.random.default_rng(31)
    jh, th = _bf16(rng, 2, 50, 64)
    jw, tw = _bf16(rng, 96, 64)
    labels = rng.integers(0, 96, (2, 50)).astype(np.int32)

    def jax_loss(h, w):
        return jlayers.chunked_softmax_xent(
            lambda hc: jnp.einsum("...d,vd->...v", hc, w).astype(jnp.float32),
            h, jnp.asarray(labels), 16)

    want, (jgh, jgw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jh, jw)
    th.requires_grad_(True)
    tw.requires_grad_(True)
    got = layers.chunked_softmax_xent(lambda hc: (hc @ tw.T).float(), th,
                                      torch.from_numpy(labels), 16)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _assert_ulps(jgh, th.grad, XENT_ULPS, "h")
    _assert_ulps(jgw, tw.grad, XENT_ULPS, "w")


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (7, 0.0), (None, 30.0)])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_chunked_attention_grads_match_jax(h, kvh, window, softcap):
    """Causal, windowed and soft-capped attention over query chunks of 8
    (the last one short), MHA and GQA: the q, k and v cotangents of a random
    output cotangent against ``jax.vjp`` of the JAX function, within
    ATTN_ULPS.  The port recomputes each chunk in backward."""
    rng = np.random.default_rng(32)
    jq, tq = _bf16(rng, 2, 20, h, 32)
    jk, tk = _bf16(rng, 2, 20, kvh, 32)
    jv, tv = _bf16(rng, 2, 20, kvh, 32)
    jg, tg = _bf16(rng, 2, 20, h, 32)
    kw = dict(causal=True, window=window, softcap=softcap, chunk=8)
    _, vjp = jax.vjp(lambda q, k, v: jattn.chunked_attention(q, k, v, **kw), jq, jk, jv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    attn.chunked_attention(tq, tk, tv, **kw).backward(tg)
    for name, w, t in zip("qkv", vjp(jg), (tq, tk, tv)):
        _assert_ulps(w, t.grad, ATTN_ULPS, name)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = {"a": (64, 32), "b": (17,), "c": (8, 8, 8)}
BF16 = {"a", "c"}           # compute leaves in bf16; "b" stays f32


def _to_torch(tree):
    """A JAX tree of SHAPES' leaves as torch tensors of the same dtypes."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k in BF16 else torch.float32) for k, v in tree.items()}


def _params(rng):
    return {k: jnp.asarray(rng.standard_normal(s).astype(np.float32),
                           jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, s in SHAPES.items()}


def _grads(values, jp):
    jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in values.items()}
    return jg, _to_torch(jg)


def _state_to_torch(js):
    return opt.OptState(
        step=torch.tensor(int(js.step), dtype=torch.int32),
        **{f: {k: torch.from_numpy(np.array(v)) for k, v in getattr(js, f).items()}
           for f in ("master", "m", "v")})


def test_adamw_update_matches_jax():
    """Six updates, alternating gradient norms under and over the clip:
    each starts from JAX's state and takes JAX's gradients.  The gradients
    lie on a grid of 1/4 with squares that f32 sums exactly in any order,
    so both global norms are the same f32 value (on other values the two
    reductions sum in other orders; ``test_global_norm_matches_jax``).
    Master, m and v equal JAX's within 1 f32 ulp, the bf16 and f32
    parameters equal JAX's, and so do the reported norm and learning rate."""
    rng = np.random.default_rng(33)
    jp = _params(rng)
    js = jopt.adamw_init(jp)
    j_lr, t_lr = jopt.cosine_schedule(1e-2, 3, 10), opt.cosine_schedule(1e-2, 3, 10)
    for it in range(6):
        big = it % 2 == 1
        g = {k: rng.integers(-8, 9, s).astype(np.float32) / (4 if big else 4096)
             for k, s in SHAPES.items()}
        jg, tg = _grads(g, jp)
        tp, ts = _to_torch(jp), _state_to_torch(js)
        jp, js, jst = jopt.adamw_update(jg, js, jp, lr_fn=j_lr)
        tp, ts, tst = opt.adamw_update(tg, ts, tp, lr_fn=t_lr)
        assert (float(jst["grad_norm"]) > 1.0) == big
        assert tst["grad_norm"].item() == float(jst["grad_norm"])
        assert tst["lr"].item() == float(jst["lr"]) and int(ts.step) == int(js.step)
        for f in ("master", "m", "v"):
            for k in SHAPES:
                assert _f32_ulps(getattr(js, f)[k], getattr(ts, f)[k].numpy()) <= 1, (it, f, k)
        for k in SHAPES:
            assert tp[k].dtype == (torch.bfloat16 if k in BF16 else torch.float32)
            np.testing.assert_array_equal(np.asarray(jp[k], np.float32), _np(tp[k]))


def test_global_norm_matches_jax():
    """On random gradients the two f32 sums of squares run in other orders:
    the norm within 2^-18 of JAX's, relative."""
    rng = np.random.default_rng(34)
    jg, tg = _grads({k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()},
                    _params(rng))
    np.testing.assert_allclose(opt.global_norm(tg).item(), float(jopt.global_norm(jg)),
                               rtol=2 ** -18)


def test_grad_clip_reports_pre_clip_norm():
    params = {"w": torch.ones(4)}
    state = opt.adamw_init(params)
    big = {"w": torch.full((4,), 1e6)}
    _, _, stats = opt.adamw_update(big, state, params, lr_fn=lambda s: torch.tensor(0.1),
                                   clip_norm=1.0)
    assert stats["grad_norm"].item() > 1e5
    assert state.m["w"].abs().max().item() <= 0.1 * 0.5 + 1e-7   # (1 - b1) * g / |g|


def test_adamw_descends_quadratic():
    params = {"w": torch.full((8,), 5.0)}
    state = opt.adamw_init(params)
    lr_fn = opt.cosine_schedule(0.5, warmup=0, total=100)
    for _ in range(60):
        params, state, stats = opt.adamw_update({"w": 2 * params["w"]}, state, params,
                                                lr_fn=lr_fn, weight_decay=0.0)
    assert params["w"].abs().max().item() < 0.5
    assert np.isfinite(stats["grad_norm"].item())


def test_cosine_schedule_matches_jax():
    """Every step of a 20-step warm-up and a decay to step 300 (and 20 past
    it): equal to the JAX schedule, except where XLA's f32 cosine of the
    step's angle is not correctly rounded (the port's is): there within 2
    f32 ulps."""
    base, warm, total = 3e-3, 20, 300
    j_lr, t_lr = jopt.cosine_schedule(base, warm, total), opt.cosine_schedule(base, warm, total)
    off = []
    for s in range(total + 20):
        want = np.float32(j_lr(jnp.int32(s)))
        got = np.float32(t_lr(torch.tensor(s, dtype=torch.int32)).item())
        if want == got:
            continue
        prog = jnp.clip((jnp.float32(s) - warm) / (total - warm), 0.0, 1.0)
        angle = jnp.pi * prog
        assert np.float32(jnp.cos(angle)) != np.float32(math.cos(float(angle))), s
        assert _f32_ulps(want, got) <= 2, s
        off.append(s)
    assert len(off) <= 5, off


# ---------------------------------------------------------------------------
# data, elastic, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,host,n_hosts", [(0, 0, 1), (3, 1, 2)])
def test_synthetic_lm_matches_jax(seed, host, n_hosts):
    want = JaxSyntheticLM(300, 32, 8, seed=seed, host_id=host, n_hosts=n_hosts)
    got = SyntheticLM(300, 32, 8, seed=seed, host_id=host, n_hosts=n_hosts)
    for step in (0, 1, 7, 1000):
        a, b = want.batch(step), got.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    pf = Prefetcher(got.batch, start_step=5)
    try:
        step, batch = next(pf)
        assert step == 5
        np.testing.assert_array_equal(batch["tokens"], want.batch(5)["tokens"])
    finally:
        pf.stop()


def test_straggler_tracker_matches_jax():
    rng = np.random.default_rng(35)
    times = rng.exponential(1.0, (40, 4)) * np.array([1.0, 1.0, 2.2, 1.0])
    want, got = jelastic.StragglerTracker(4, patience=3), elastic.StragglerTracker(4, patience=3)
    for row in times:
        for h, t in enumerate(row):
            want.record(h, float(t))
            got.record(h, float(t))
        assert want.check() == got.check()
        np.testing.assert_array_equal(want.strikes, got.strikes)
    assert elastic.StragglerTracker(3).check() == []


def test_plan_remesh_matches_jax():
    for n in (16, 17, 64, 240, 256):
        for mp in (1, 4, 16):
            for gb in (8, 96, 256):
                if n >= mp:
                    assert (elastic.plan_remesh(n, mp, gb)
                            == jelastic.plan_remesh(n_devices=n, model_parallel=mp,
                                                    global_batch=gb))


def test_heartbeats_and_watchdog_match_jax(tmp_path):
    """Hosts 0 and 2 beat, host 1's file is corrupt, host 3 never beats:
    both watchdogs call 0 and 2 alive and 1 and 3 dead."""
    for h in (0, 2):
        elastic.Heartbeater(tmp_path, h).beat(5)
    (tmp_path / "host_1.hb").write_text("{not json")
    for dead_after in (120.0, -1.0):
        want = jelastic.Watchdog(tmp_path, 4, dead_after=dead_after)
        got = elastic.Watchdog(tmp_path, 4, dead_after=dead_after)
        assert got.alive() == want.alive() and got.dead() == want.dead()
    assert elastic.Watchdog(tmp_path, 4).alive() == [0, 2]


def test_serving_records_no_graph():
    """``ParamTree`` is frozen by default: prefill and decode record no
    autograd graph (serving captures plain kernels); made trainable, the
    same model's loss does."""
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    m = make_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = m.prefill(params, {"tokens": toks})
    assert logits.grad_fn is None and cache["k"].grad_fn is None
    cache = m.init_cache(2, 16, device="cpu")
    logits, cache = m.decode_step(params, toks[:, :1], cache, 0)
    assert logits.grad_fn is None and not any(p.requires_grad for p in params.parameters())
    params.requires_grad_(True)
    loss, _ = m.loss(params, {"tokens": toks, "labels": toks})
    assert loss.grad_fn is not None
