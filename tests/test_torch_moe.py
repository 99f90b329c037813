"""The port's MoE decoders (olmoe and phi3.5-moe) against the JAX package's,
on the CPU, at smoke size.

The MoE FFN alone (``moe_apply`` with capacity drops, ``moe_decode``), the
model's prefill and teacher-forced decode, and the whole ``ServeEngine``
(paged and contiguous, in-flight and megastep) on the same numpy-seeded
inputs and the JAX parameters carried by ``params_from_numpy``.  The
routing is f32 on both sides, so on equal inputs the expert choices and drop
counts are equal; the expert SwiGLU is bf16 and agrees to a few bf16 ulps
(``LAYER_TOL``).  Deeper in a model the router's input is a hidden state
that the two frameworks round differently, so where two experts' gates are
nearly tied the choice may flip: the engine test finds the first such flip
and holds it to a near-tie of the JAX router (``ROUTER_TIE``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.serving import engine
from test_torch_models import (LAYER_TOL, _bf16, _check_prefill_and_decode,
                               _close, _pair)
from test_torch_serving import _assert_streams_equal_or_tied, _drive, _prompts, _summary

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
# A routing choice may flip between the frameworks where the JAX router's
# k-th and (k+1)-th probabilities lie within this gap.  The router reads a
# bf16 hidden state that the two round differently (about one ulp, 2^-8
# relative); on these configs that moves a probability by up to 0.0019 before
# the first flip, and the flips found sit at gaps of 5e-5 to 8e-4.
ROUTER_TIE = 2 ** -7


@pytest.fixture(scope="module", params=MOE)
def moe_pair(request):
    """(jax cfg, port cfg, jax model, jax params, port model, port params)
    for an MoE smoke config."""
    return _pair(jax_get_config(request.param, smoke=True),
                 get_config(request.param, smoke=True))


def _layer0_mlp(pair_):
    _, cfg, _, jp, _, tp = pair_
    return jax.tree.map(lambda x: x[0], jp["blocks"]["mlp"]), tp["blocks"][0]["mlp"], cfg


def _jax_route(jp_mlp, jx, k):
    """The JAX ``moe_apply``'s routing lines: f32 router, softmax, top-k."""
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32), jp_mlp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    return probs, jax.lax.top_k(probs, k)[1]


@pytest.mark.parametrize("skew", [False, True])
def test_moe_apply_matches_jax(moe_pair, skew):
    """``moe_apply`` on 4 rows of 24 tokens: the expert choices and the
    number of dropped choices equal JAX's; ``y`` and the aux losses within
    LAYER_TOL.  ``skew`` adds a direction u to every token and 3u to the
    router's expert-0 column, so expert 0 tops every token's choice and
    overflows its capacity: choices drop."""
    jp_mlp, tp_mlp, cfg = _layer0_mlp(moe_pair)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((4, 24, cfg.d_model)).astype(np.float32)
    if skew:
        u = rng.standard_normal(cfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x = x + 4 * u
        router = np.asarray(jp_mlp["router"]).copy()
        router[:, 0] += 3 * u
        jp_mlp = {**jp_mlp, "router": jnp.asarray(router)}
        tp_mlp = {**{k: tp_mlp[k] for k in ("w_gate", "w_up", "w_down")},
                  "router": torch.from_numpy(router)}
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.capacity_factor)
    jy, jaux = jmoe.moe_apply(jp_mlp, jx, group_chunk=cfg.moe_group_chunk, **kw)
    ty, taux = moe.moe_apply(tp_mlp, tx, **kw)

    probs, want_i = _jax_route(jp_mlp, jx, cfg.moe_top_k)
    _, t_probs, _, got_i = moe.route(tp_mlp, tx, cfg.moe_top_k)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_allclose(np.asarray(probs), t_probs.numpy(), rtol=1e-5, atol=1e-6)
    n = 4 * 24 * cfg.moe_top_k
    dropped = round(float(jaux["drop_frac"]) * n)
    assert round(float(taux["drop_frac"]) * n) == dropped
    assert dropped > 0 or not skew
    _close(jy, ty, LAYER_TOL)
    for name in ("lb_loss", "z_loss", "drop_frac"):
        assert taux[name].dtype == torch.float32 and taux[name].dim() == 0
        _close(jaux[name], taux[name], LAYER_TOL)


def test_moe_decode_matches_jax(moe_pair):
    """``moe_decode`` (every expert on the B tokens, combined through the f32
    gate mask) against JAX's, within LAYER_TOL."""
    jp_mlp, tp_mlp, cfg = _layer0_mlp(moe_pair)
    jx, tx = _bf16(np.random.default_rng(22), 5, 1, cfg.d_model)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k)
    _close(jmoe.moe_decode(jp_mlp, jx, **kw), moe.moe_decode(tp_mlp, tx, **kw), LAYER_TOL)


def test_moe_prefill_and_teacher_forced_decode_match_jax(moe_pair):
    """The model: prefill of 4 rows (capacity dispatch) and six
    teacher-forced decode steps (every expert), logits within DEEP_TOL and
    greedy tokens equal up to bf16 ties.  (Four rows: the JAX ``moe_apply``
    needs the batch to be a multiple of ``moe_group_chunk``.)"""
    _check_prefill_and_decode(moe_pair, rows=4)


def _record_routing(monkeypatch):
    """Log every routing call of the port's engine and of the JAX package's,
    in call order, as [probabilities (tokens, E), choices (tokens, k),
    the tokens whose routing the engine keeps].  A prefill keeps every
    token.  A decode launch keeps the rows that emit, which the port's
    engine hands to ``freeze_rows`` after the step: the other rows are
    idle, retired or waiting slots, which the two engines park at other
    positions.  The JAX side records from inside its jitted functions (a
    ``jax.debug.callback`` in wrappers of ``moe_apply`` and ``moe_decode``;
    a model made after this call traces the wrappers)."""
    port_log, jax_log = [], []

    def port(fn, decode):
        def wrapped(params, x, *, n_experts, top_k, **kw):
            _, probs, _, gi = moe.route(params, x, top_k)
            port_log.append([probs.reshape(-1, n_experts).numpy(),
                             gi.reshape(-1, top_k).numpy(), None if decode else True])
            return fn(params, x, n_experts=n_experts, top_k=top_k, **kw)
        return wrapped

    freeze = engine.freeze_rows

    def port_freeze(cache, new, leaves, keep):
        for entry in port_log:
            if entry[2] is None:
                entry[2] = np.array(torch.as_tensor(keep))
        return freeze(cache, new, leaves, keep)

    def record(fn):
        def wrapped(params, x, *, n_experts, top_k, **kw):
            logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), params["router"])
            probs = jax.nn.softmax(logits, axis=-1)
            jax.debug.callback(
                lambda p, g: jax_log.append((np.asarray(p).reshape(-1, n_experts),
                                             np.asarray(g).reshape(-1, top_k))),
                probs, jax.lax.top_k(probs, top_k)[1], ordered=True)
            return fn(params, x, n_experts=n_experts, top_k=top_k, **kw)
        return wrapped

    monkeypatch.setattr(moe, "moe_apply", port(moe.moe_apply, decode=False))
    monkeypatch.setattr(moe, "moe_decode", port(moe.moe_decode, decode=True))
    monkeypatch.setattr(engine, "freeze_rows", port_freeze)
    monkeypatch.setattr(jmoe, "moe_apply", record(jmoe.moe_apply))
    monkeypatch.setattr(jmoe, "moe_decode", record(jmoe.moe_decode))
    return port_log, jax_log


def _first_flip(port_log, jax_log, top_k):
    """The first routing call at which the two choose other experts for a
    token the engine keeps, as (call, JAX's k-th minus (k+1)-th probability
    at each such token), or None.  Both make the same calls on the same
    padded shapes."""
    assert len(port_log) == len(jax_log) > 0
    for c, ((pp, pg, keep), (jp_, jg)) in enumerate(zip(port_log, jax_log)):
        assert pp.shape == jp_.shape and pg.shape == jg.shape, c
        rows = np.nonzero((np.sort(pg, -1) != np.sort(jg, -1)).any(-1) & keep)[0]
        if len(rows):
            top = -np.sort(-jp_[rows], -1)
            return c, top[:, top_k - 1] - top[:, top_k]
    return None


@pytest.mark.parametrize("decode_mode", ["inflight", "megastep"])
@pytest.mark.parametrize("kv_mode", ["paged", "contiguous"])
def test_moe_engine_matches_jax(moe_pair, kv_mode, decode_mode, monkeypatch):
    """The MoE smoke configs through the engine against the JAX engine on
    the paged-decode trace: finish order, prefill split, ticks, counters,
    refcounts and prefix-cache stats equal, and the same routing calls on
    the same padded shapes (the batched continuation prefill pads to
    (pow2 rows, pow2 rest) as JAX does, so each row's capacity is JAX's).
    Up to the first call where the expert choices differ they are equal,
    and every choice that differs there is a near-tie of the JAX router
    (``ROUTER_TIE``).  With no such flip, the token streams are equal but
    where they split at a bf16 tie of the logits; past a flip the streams
    go their own ways, and only their lengths are held."""
    jcfg, cfg, jm, jp, tm, tp = moe_pair
    prompts = _prompts(jcfg)
    kw = dict(kv_mode=kv_mode, decode_mode=decode_mode)
    port_log, jax_log = _record_routing(monkeypatch)
    jm = jax_make_model(jcfg)
    got = _summary(_drive(True, (cfg, tm, tp), prompts, **kw))
    want = _summary(_drive(False, (jcfg, jm, jp), prompts, **kw))
    got_t, want_t = got.pop("tokens"), want.pop("tokens")
    assert got == want
    flip = _first_flip(port_log, jax_log, cfg.moe_top_k)
    if flip is None:
        _assert_streams_equal_or_tied(jm, jp, prompts, got_t, want_t)
    else:
        assert np.all(flip[1] <= ROUTER_TIE), flip
        assert {r: len(t) for r, t in got_t.items()} == {r: len(t) for r, t in want_t.items()}
    if kv_mode == "paged":
        assert got["stats"]["gather_calls"] == 0
    if decode_mode == "megastep":
        assert got["stats"]["megastep_windows"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_launcher_serves_moe_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --kv-mode paged
    --arch <moe arch>``: every request served, prefix hits, no prefix copy."""
    serve.main(["--device", "cpu", "--kv-mode", "paged", "--arch", arch,
                "--requests", "8"])
    out = capsys.readouterr().out
    assert "8 requests in" in out and "gather_calls=0" in out
    assert "skipped=0 " not in out
