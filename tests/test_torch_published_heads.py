"""The three largest architectures at their published head and routing
geometry, against the JAX package, on the CPU.

command-r-35b (64 query heads on 8 KV heads, Dh 128, rope theta 8e6, a
parallel block with LayerNorm), qwen2-vl-72b (64 on 8, Dh 128, M-RoPE over
64 frequency slots split 16/24/24) and phi3.5-moe-42b-a6.6b (32 on 8, 16
experts, top-2, capacity 1.25, dispatch groups of 32) keep every published
field that shapes attention and routing; only what costs CPU time is
narrowed (``narrowed``: 2 layers, d_model 256, d_ff 256, or 64 per
expert, a 512-word vocabulary, the smoke configs' 32-token attention and
loss chunks).  The smoke configs (Dh 16, 2-4 experts) never run these
shapes; the card serves the same geometry at full width
(``chip_smoke.py`` phases 16(b)-(d)).  Parameters are the JAX model's from
``PRNGKey(0)``, carried by ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models.model import make_model as jax_make_model
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.serving import engine
from repro_torch.serving.engine import _pow2
from test_torch_models import _pair
import test_torch_moe
from test_torch_moe import ROUTER_TIE, _record_routing
from test_torch_serving import _assert_streams_equal_or_tied, _drive, _prompts, _summary
from test_torch_serving_families import _assert_same_greedy, _equal_length_prompts

COMMAND_R, QWEN2_VL, PHI35_MOE = "command-r-35b", "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b"
# what is narrowed; every other field is the published config's
NARROW = dict(n_layers=2, d_model=256, vocab_size=512, attn_chunk=32, loss_chunk=32)
# two tokens' logits this close are a bf16 tie (the model tests' tolerance)
LOGIT_TIE = 0.03


def narrowed(get, arch):
    """``arch``'s published config (from the JAX package's ``get`` or the
    port's) at NARROW's size, d_ff 256 (64 per expert for an MoE)."""
    cfg = get(arch)
    return dataclasses.replace(cfg, **NARROW, d_head=cfg.head_dim,
                               d_ff=64 if cfg.ffn == "moe" else 256)


def _stack(arch):
    """(jax cfg, port cfg, jax model, jax params, port model, port params)."""
    jcfg, cfg = narrowed(jax_get_config, arch), narrowed(get_config, arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return _pair(jcfg, cfg)


@pytest.mark.parametrize("arch,geometry,params", [
    (COMMAND_R, dict(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=8e6,
                     parallel_block=True, norm="ln"), 32_380_698_624),
    (QWEN2_VL, dict(n_heads=64, n_kv_heads=8, head_dim=128, rope_kind="mrope"),
     72_705_384_448),
    (PHI35_MOE, dict(n_heads=32, n_kv_heads=8, head_dim=128, n_experts=16, moe_top_k=2,
                     capacity_factor=1.25, moe_group_chunk=32), 41_872_527_360)])
def test_published_config_geometry_and_count(arch, geometry, params):
    """The port's published config is the JAX package's, and its
    ``param_count`` is every leaf the JAX init makes (shapes traced, not
    drawn): command-r-35b's 64.8 GB of bf16 weights fit the card's 80 GB
    whole, qwen2-vl-72b's 145.4 and phi3.5-moe's 83.7 GB do not (the card
    serves them at 8 layers).  The narrowed configs of these tests keep
    the published head, RoPE, norm, block and routing fields."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0))
    assert cfg.param_count() == sum(x.size for x in jax.tree.leaves(shapes)) == params
    assert (2 * params < 80e9) == (arch == COMMAND_R)
    for narrow in (narrowed(get_config, arch), narrowed(jax_get_config, arch)):
        for name, want in geometry.items():
            assert getattr(narrow, name) == getattr(cfg, name) == want, (arch, name)


def test_command_r_paged_engine_matches_jax():
    """command-r at its published heads through the port's paged engine,
    in-flight, against the JAX engine: finish order, prefill split, ticks,
    counters, refcounts and prefix-cache stats equal, and every stream
    equal but where the two split at a bf16 tie."""
    jcfg, cfg, jm, jp, tm, tp = _stack(COMMAND_R)
    prompts = _prompts(jcfg)
    got = _summary(_drive(True, (cfg, tm, tp), prompts, kv_mode="paged"))
    want = _summary(_drive(False, (jcfg, jm, jp), prompts, kv_mode="paged"))
    _assert_streams_equal_or_tied(jm, jp, prompts, got.pop("tokens"), want.pop("tokens"))
    assert got == want
    assert got["stats"]["gather_calls"] == 0


def test_qwen2_vl_paged_serve_gives_the_jax_model_path_tokens():
    """qwen2-vl at its published heads (M-RoPE at Dh 128) through the
    port's paged engine gives the greedy tokens of the JAX model path
    (prefill over each whole prompt on (B, 3, S) streams, then
    ``decode_step``), up to bf16 ties in JAX's own logits.  (The JAX
    engine's M-RoPE prefill is broken: ROADMAP Queue 3.)"""
    jcfg, cfg, jm, jp, tm, tp = _stack(QWEN2_VL)
    prompts = _equal_length_prompts(jcfg)
    eng = _drive(True, (cfg, tm, tp), prompts, kv_mode="paged")
    assert len(eng.finished) == len(prompts) and eng.stats()["gather_calls"] == 0
    assert sum(r.prefill_skipped for r in eng.finished) > 0
    toks = np.array([next(r for r in eng.finished if r.rid == i).out_tokens
                     for i in range(len(prompts))], np.int32)
    n, steps = len(prompts[0]), toks.shape[1]
    cache = jm.init_cache(len(prompts), n + steps)
    logits, c = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(np.stack(prompts))})
    cache = {k: cache[k].at[:, :, :n].set(c[k]) for k in cache}
    decode = jax.jit(jm.decode_step)
    for j in range(steps):
        _assert_same_greedy(logits, toks[:, j])
        if j + 1 < steps:
            logits, cache = decode(jp, jnp.asarray(toks[:, j:j + 1]), cache,
                                   jnp.int32(n + j))


def test_mrope_at_dh_128_splits_16_24_24_as_jax():
    """``apply_mrope`` at Dh 128 on three distinct position streams (t, h,
    w) within 1e-6 of JAX's (f32 operands), and each frequency slot rotated
    by its own stream: slots 0-15 by t, 16-39 by h, 40-63 by w, as
    ``apply_rope`` with that stream rotates them."""
    rng = np.random.default_rng(11)
    b, s, h, dh, theta = 2, 12, 4, 128, 1e6
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    pos = np.stack([np.arange(s) + 3, 2 * np.arange(s) % 7, 500 + np.arange(s) * 5])
    pos = np.broadcast_to(pos, (b, 3, s)).astype(np.int32)
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    slots = got.reshape(b, s, h, dh // 2, 2)
    for stream, (lo, hi) in enumerate([(0, 16), (16, 40), (40, 64)]):
        rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, stream]), theta)
        assert torch.equal(slots[..., lo:hi, :], rope.reshape(b, s, h, dh // 2, 2)[..., lo:hi, :])
        others = torch.ones(dh // 2, dtype=torch.bool)
        others[lo:hi] = False
        assert not torch.equal(slots[..., others, :],
                               rope.reshape(b, s, h, dh // 2, 2)[..., others, :])


@pytest.mark.parametrize("case", ["dispatch", "dispatch_with_drops", "decode"])
def test_phi35_moe_ffn_matches_jax(case):
    """The MoE FFN at phi3.5-moe's routing (16 experts, top-2, capacity
    1.25, dispatch groups of 32), layer 0 of the narrowed model, held as
    ``test_torch_moe.py`` holds the smoke configs' (equal expert choices
    and drop counts, outputs within LAYER_TOL): ``moe_apply``, also with
    every token pushed to expert 0 past its capacity, and ``moe_decode``."""
    pair = _stack(PHI35_MOE)
    if case == "decode":
        test_torch_moe.test_moe_decode_matches_jax(pair)
    else:
        test_torch_moe.test_moe_apply_matches_jax(pair, skew=case == "dispatch_with_drops")


def _tag_rows(monkeypatch):
    """The request behind each token row of every prefill wave and decode
    launch of the port's engine, in launch order: ("prefill", (rows, S)) or
    ("decode", (slots,)), -1 for a padding row or token or a slot that does
    not emit; and the JAX engine's logits (rows, V) of each of its waves and
    launches, in order (a ``jax.debug.callback`` in wrappers of its paged
    prefill and decode, which its engine traces when made after this call).
    The two engines run the same waves and launches on the same padded
    shapes when their summaries are equal."""
    tags, jax_logits = [], []
    wave, launch = engine.ServeEngine._prefill_wave, engine.ServeEngine._launch_decode

    def tagged_wave(self, jobs, to_write, ct):
        if jobs:
            rests = [len(j["req"].prompt) - len(j["pages"]) * ct for j in jobs]
            rows = np.full((_pow2(len(jobs)), _pow2(max(rests))), -1)
            for i, (j, rest) in enumerate(zip(jobs, rests)):
                rows[i, :rest] = j["req"].rid
            tags.append(("prefill", rows))
        return wave(self, jobs, to_write, ct)

    def tagged_launch(self, live, emit):
        rows = np.full(self.slots, -1)
        for r in self.active.values():
            rows[r.slot] = r.rid if emit[r.slot] else -1
        tags.append(("decode", rows))
        return launch(self, live, emit)

    def record(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(lambda x: jax_logits.append(np.asarray(x)), out[0],
                               ordered=True)
            return out
        return wrapped

    monkeypatch.setattr(engine.ServeEngine, "_prefill_wave", tagged_wave)
    monkeypatch.setattr(engine.ServeEngine, "_launch_decode", tagged_launch)
    for name in ("batched_continuation_prefill", "paged_decode_step"):
        monkeypatch.setattr(jengine, name, record(getattr(jengine, name)))
    return tags, jax_logits


def _parted(port_log, jax_log, tags, jax_logits, got, want, n_layers, top_k):
    """Where each request's run first parts from the JAX engine's: rid ->
    ("router", JAX's k-th minus (k+1)-th probability at each token whose
    expert choices differ) when its routing differs first, while its tokens
    are still equal (in its prefill, or a decode launch that feeds no
    differing token); ("token", the gap between the two tokens in the JAX
    engine's own logits at that step) when its stream splits first."""
    assert len(port_log) == len(jax_log) == n_layers * len(tags) > 0
    assert len(jax_logits) == len(tags)
    split = {r: next((j for j, (a, b) in enumerate(zip(got[r], t)) if a != b), None)
             for r, t in want.items()}
    out, steps = {}, {}
    for w, (kind, rows) in enumerate(tags):
        flat = rows.reshape(-1)
        for c in range(w * n_layers, (w + 1) * n_layers):
            (_, pg, _), (jp_, jg) = port_log[c], jax_log[c]
            assert pg.shape == jg.shape == (len(flat), top_k), c
            differ = (np.sort(pg, -1) != np.sort(jg, -1)).any(-1)
            for r in set(flat[differ & (flat >= 0)].tolist()) - set(out):
                top = -np.sort(-jp_[differ & (flat == r)], -1)
                out[r] = ("router", top[:, top_k - 1] - top[:, top_k])
        # the step each emitting row's token is: 0 in its prefill, n at its
        # n-th decode launch (which feeds step n - 1's token)
        emits = rows[:, 0] if kind == "prefill" else rows
        for i, r in enumerate(emits.tolist()):
            if r < 0:
                continue
            steps[r] = steps.get(r, -1) + 1
            if steps[r] == split[r] and r not in out:
                lg = jax_logits[w][i]
                out[r] = ("token", abs(float(lg[want[r][split[r]]] - lg[got[r][split[r]]])))
    return out


def test_phi35_moe_paged_engine_matches_jax(monkeypatch):
    """phi3.5-moe at its published heads and routing (16 experts, top-2,
    capacity 1.25, groups of 32) through the port's paged engine, in-flight,
    against the JAX engine, every routing call recorded on both sides and
    each token row tagged with its request: summaries equal, the same calls
    on the same padded shapes, and each request's routing and stream equal
    to JAX's, or parted first by a near-tie on its own path (``_parted``):
    its expert choices at a JAX router gap under ``ROUTER_TIE``, or its
    token at a gap under LOGIT_TIE in the JAX engine's logits.  (Not the
    JAX *model* path's: a continuation prefill routes only the prompt's
    rest, into capacities of its padded length, so an MoE engine's logits
    are not the model path's.)  Past that point only lengths are held."""
    jcfg, cfg, _, jp, tm, tp = _stack(PHI35_MOE)
    prompts = _prompts(jcfg)
    port_log, jax_log = _record_routing(monkeypatch)
    tags, jax_logits = _tag_rows(monkeypatch)
    jm = jax_make_model(jcfg)           # traces the recording wrappers
    got = _summary(_drive(True, (cfg, tm, tp), prompts, kv_mode="paged"))
    want = _summary(_drive(False, (jcfg, jm, jp), prompts, kv_mode="paged"))
    got_t, want_t = got.pop("tokens"), want.pop("tokens")
    assert got == want
    assert got["stats"]["gather_calls"] == 0
    assert {r: len(t) for r, t in got_t.items()} == {r: len(t) for r, t in want_t.items()}
    parted = _parted(port_log, jax_log, tags, jax_logits, got_t, want_t, cfg.n_layers,
                     cfg.moe_top_k)
    for r, (why, gap) in parted.items():
        assert np.all(gap <= (ROUTER_TIE if why == "router" else LOGIT_TIE)), (r, why, gap)
    assert all(r in parted for r in want_t if got_t[r] != want_t[r])
