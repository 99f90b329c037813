"""The port's serving engine against the JAX package's for the
attention-decoder families, on the CPU, and the port's launcher.

Each family's smoke config (gemma3, starcoder2, command-r) through the
paged engine, in-flight and megastep, against the JAX engine; qwen2-vl's
M-RoPE serve against the JAX *model* path (the JAX engine's M-RoPE prefill
is broken) and, inside the port, against its contiguous and its RoPE serve;
``python -m repro_torch.launch.serve --device cpu`` for every family, with
and without the prefix cache, and in megastep.  The phi3-mini engine, the
prefix cache and the pool are in ``test_torch_serving.py``, whose engine
helpers this file shares.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.core import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from test_torch_serving import ARCH, _assert_streams_equal_or_tied, _drive, _prompts, _summary

FAMILIES = ["gemma3-1b", "starcoder2-7b", "command-r-35b"]
MROPE = "qwen2-vl-72b"


@functools.lru_cache(maxsize=None)
def _family(arch):
    """A family's JAX smoke model and parameters, carried into the port."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, jm, jp), (cfg, make_model(cfg), tp)


@pytest.mark.parametrize("decode_mode", ["inflight", "megastep"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_engine_matches_jax(arch, decode_mode):
    """Each family's smoke config through the paged engine against the
    JAX engine: finish order, prefill split, ticks, counters, refcounts and
    prefix-cache stats equal, and every token stream equal but where the
    two split at a bf16 tie (``_assert_streams_equal_or_tied``).  Prompts
    of 37-45 tokens with 6 new: gemma3's windows of 16 bind, starcoder2's
    of 32 too."""
    (jcfg, jm, jp), port_stack = _family(arch)
    prompts = _prompts(jcfg)
    kw = dict(decode_mode=decode_mode)
    got = _summary(_drive(True, port_stack, prompts, kv_mode="paged", **kw))
    want = _summary(_drive(False, (jcfg, jm, jp), prompts, kv_mode="paged", **kw))
    _assert_streams_equal_or_tied(jm, jp, prompts, got.pop("tokens"), want.pop("tokens"))
    assert got == want
    assert got["stats"]["gather_calls"] == 0
    if decode_mode == "megastep":
        assert got["stats"]["megastep_windows"] > 0


def _equal_length_prompts(cfg, n=6, prefix=32, suffix=8, seed=3):
    """Prompts of one length (shared 32-token templates, 8-token suffixes),
    so that the JAX model path prefills them all in one batch."""
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(1, cfg.vocab_size, prefix).astype(np.int32) for _ in range(3)]
    return [np.concatenate([tmpl[i % 3], rng.integers(1, cfg.vocab_size, suffix)
                            .astype(np.int32)]) for i in range(n)]


def test_mrope_serve_gives_the_jax_model_path_tokens():
    """qwen2-vl-smoke through the port's paged engine gives the greedy
    tokens of the JAX *model* path (``prefill`` over each whole prompt, then
    ``decode_step``, both on (B, 3, S) position streams), up to bf16 ties
    in JAX's own teacher-forced logits.  The JAX engine cannot be the
    reference here: it hands M-RoPE (B, S) positions, which make NaN."""
    (jcfg, jm, jp), port_stack = _family(MROPE)
    prompts = _equal_length_prompts(jcfg)
    eng = _drive(True, port_stack, prompts, kv_mode="paged")
    assert len(eng.finished) == len(prompts) and eng.stats()["gather_calls"] == 0
    assert sum(r.prefill_skipped for r in eng.finished) > 0     # prefix hits
    toks = np.array([next(r for r in eng.finished if r.rid == i).out_tokens
                     for i in range(len(prompts))], np.int32)     # (B, 6)
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


def _assert_same_greedy(jl, port_tokens):
    """JAX's greedy tokens are the port's, except where JAX's logits of the
    two lie within the model tests' logit tolerance (0.03, a bf16 tie)."""
    jl = np.asarray(jl)
    jt = jl.argmax(-1)
    rows = np.arange(len(jt))
    margin = jl[rows, jt] - jl[rows, port_tokens]
    assert np.all((jt == port_tokens) | (margin <= 0.03)), (jt, port_tokens, margin)


def test_mrope_paged_serve_equals_contiguous_and_rope():
    """Inside the port: qwen2-vl-smoke's paged serve equals its contiguous
    serve, and, bit for bit (tokens, counters, every page of the pool), the
    serve of the same config and weights with ``rope_kind="rope"``: three
    equal M-RoPE streams are RoPE."""
    _, (cfg, model, params) = _family(MROPE)
    prompts = _prompts(cfg, seed=5)
    paged = _drive(True, (cfg, model, params), prompts, kv_mode="paged")
    contig = _drive(True, (cfg, model, params), prompts, kv_mode="contiguous")
    assert _summary(paged)["tokens"] == _summary(contig)["tokens"]
    rope_cfg = dataclasses.replace(cfg, rope_kind="rope")
    rope = _drive(True, (rope_cfg, make_model(rope_cfg), params), prompts, kv_mode="paged")
    assert _summary(paged) == _summary(rope)
    assert torch.equal(paged.pool.k, rope.pool.k) and torch.equal(paged.pool.v, rope.pool.v)


@pytest.mark.parametrize("arch", FAMILIES + [MROPE])
def test_launcher_serves_each_arch_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --kv-mode paged
    --arch <arch>``: every request served, no prefix copy."""
    serve.main(["--device", "cpu", "--kv-mode", "paged", "--arch", arch, "--requests", "8"])
    out = capsys.readouterr().out
    assert "8 requests in" in out and "gather_calls=0" in out


def test_launcher_serves_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` at smoke size:
    the launcher's request mix through the paged engine, every request
    served, prefix hits skipping prefill, no prefix copy."""
    serve.main(["--device", "cpu", "--kv-mode", "paged", "--requests", "10"])
    out = capsys.readouterr().out
    assert "10 requests in" in out and "gather_calls=0" in out
    args = serve.parser().parse_args(["--device", "cpu", "--requests", "10"])
    reqs = serve.make_requests(get_config(ARCH, smoke=True), args)
    assert [len(r.prompt) for r in reqs] == [64 + 4 + i % 13 for i in range(10)]
    with pytest.raises(ValueError, match="requires the prefix cache"):
        serve.build(serve.parser().parse_args(["--device", "cpu", "--kv-mode", "paged",
                                               "--no-prefix-cache"]))
    serve.main(["--device", "cpu", "--no-prefix-cache", "--requests", "4"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "skipped=0" in out


def test_launcher_serves_megastep_on_the_cpu(capsys):
    """``--decode-mode megastep``: the launcher's 24 requests in the
    in-flight engine's 42 ticks, in 6 windows of 6 ticks (13 decode launches
    and 19 host syncs against 43 and 49), with the ``[serve] megastep:``
    line; ``--max-window`` caps the windows."""
    serve.main(["--device", "cpu", "--decode-mode", "megastep", "--kv-mode", "paged"])
    out = capsys.readouterr().out
    assert "24 requests in 42 ticks" in out
    assert "decode: 13 launches" in out and "host_syncs=19" in out
    assert "[serve] megastep: 6 windows (mean 6.0 ticks, cap 16)" in out
    serve.main(["--device", "cpu", "--decode-mode", "megastep", "--max-window", "4",
                "--requests", "8"])
    out = capsys.readouterr().out
    assert "8 requests in" in out and "cap 4)" in out
