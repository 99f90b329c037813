"""Input specs and step bundles (``repro_torch.configs.specs``,
``repro_torch.launch.steps``) against the JAX package's.

* The specs of every arch × applicable shape (train and prefill batches,
  the decode tokens, cache and length) have JAX's ``ShapeDtypeStruct``
  shapes and dtypes, cache leaves included (mLSTM's batch on axis 2,
  Whisper's ``frames`` and cross KV, M-RoPE's ``positions``), as meta
  tensors.
* ``default_microbatches``, ``analytic_param_count`` and
  ``active_param_count`` equal JAX's for every arch.
* At smoke width, on JAX's parameters (``params_from_numpy``), the prefill
  bundle's logits and the greedy serve bundle's tokens match JAX's
  ``build_prefill_step`` / ``build_serve_step`` on ``make_debug_mesh((1,
  1))``, as ``tests/test_sharding_rules.py`` runs them: logits within
  DEEP_TOL and tokens equal up to bf16 one-ulp ties (``_assert_same_greedy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import specs as jax_specs
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_debug_mesh
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import specs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import params_from_numpy
from repro_torch.launch import steps
from repro_torch.models.model import make_model
from test_torch_models import DEEP_TOL, _assert_same_greedy, _close

_DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _leaves(tree, prefix=()):
    """{path: (shape, dtype)} of a nested dict of port tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            assert v.device.type == "meta", (prefix, k, v.device)
            out[prefix + (k,)] = (tuple(v.shape), jnp.dtype(_DTYPES[v.dtype]))
    return out


def _jax_leaves(tree):
    return {tuple(p.key for p in path): (tuple(x.shape), jnp.dtype(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = specs.applicable_shapes(cfg)
    assert [s.name for s in shapes] == [s.name for s in jax_specs.applicable_shapes(jcfg)]
    model, jmodel = make_model(cfg), jax_make_model(jcfg)
    for sh in shapes:
        jsh = JaxShapeSpec(*sh)
        for b in (None, 4):
            assert _leaves(specs.train_batch_specs(cfg, sh, b)) == \
                _jax_leaves(jax_specs.train_batch_specs(jcfg, jsh, b))
            assert _leaves(specs.prefill_batch_specs(cfg, sh, b)) == \
                _jax_leaves(jax_specs.prefill_batch_specs(jcfg, jsh, b))
        tokens, cache, cur = specs.decode_specs(model, sh)
        jtokens, jcache, jcur = jax_specs.decode_specs(jmodel, jsh)
        assert _leaves({"t": tokens, "c": cur}) == _jax_leaves({"t": jtokens, "c": jcur})
        assert _leaves(cache) == _jax_leaves(jcache)
    if cfg.rope_kind == "mrope":
        assert specs.train_batch_specs(cfg, shapes[0])["positions"].shape[1] == 3
    if cfg.enc_dec:
        assert specs.prefill_batch_specs(cfg, shapes[0])["frames"].dtype == torch.bfloat16


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_and_microbatches_match_jax(smoke):
    for arch in list_archs():
        cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
        assert cfg.analytic_param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        assert steps.default_microbatches(cfg) == jax_steps.default_microbatches(jcfg), arch


def test_bundles_carry_meta_abstract_args():
    """Every bundle's abstract inputs are meta tensors of the cell's shapes:
    building them allocates nothing, even for a 72B model."""
    cfg = get_config("qwen2-vl-72b")
    from repro_torch.configs import SHAPES
    for name, sh in SHAPES.items():
        b = steps.bundle_for(cfg, sh, microbatches=16 if sh.kind == "train" else None)
        params = b.abstract_args[0]
        assert {p.device.type for p in params.parameters()} == {"meta"}
        assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
        n_args = {"train": 3, "prefill": 2, "decode": 4}[sh.kind]
        assert len(b.abstract_args) == n_args, name
        if sh.kind == "train":
            assert b.abstract_args[1].master["head.embed"].dtype == torch.float32
            assert b.abstract_args[2]["positions"].shape == (sh.global_batch, 3, sh.seq_len)


SERVE_ARCHS = ["phi3-mini-3.8b", "whisper-medium"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_greedy_serve_bundles_match_jax(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    jm, tm = jax_make_model(jcfg), make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    mesh = make_debug_mesh((1, 1))
    b, n, smax, n_steps = 3, 20, 32, 4
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, n)).astype(np.int32)}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else jnp.int32)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "frames" else torch.int32)
              for k, v in batch.items()}

    jpre = jax_steps.build_prefill_step(jm, mesh, JaxShapeSpec("p", n, b, "prefill"))
    tpre = steps.bundle_for(cfg, ShapeSpec("p", n, b, "prefill"))
    assert _leaves(tpre.abstract_args[1]) == _jax_leaves(jpre.abstract_args[1])
    with mesh:
        jl, jc = jpre.fn(jp, jbatch)
    tl, tc = tpre.fn(tp, tbatch)
    _close(jl, tl, DEEP_TOL)
    _assert_same_greedy(jl, tl)

    dshape = ShapeSpec("d", smax, b, "decode")
    jdshape = JaxShapeSpec(*dshape)
    jgreedy = jax_steps.build_serve_step(jm, mesh, jdshape, batch=b, greedy=True)
    jlogits = jax_steps.build_serve_step(jm, mesh, jdshape, batch=b)
    tgreedy = steps.bundle_for(cfg, dshape, greedy=True)
    tlogits = steps.build_serve_step(tm, dshape)
    assert _leaves(tgreedy.abstract_args[2]) == _jax_leaves(jgreedy.abstract_args[2])
    jcache = jm.init_cache(b, smax)
    tcache = tm.init_cache(b, smax, device="cpu")
    for k in jc:
        if k in ("xk", "xv"):
            jcache[k], tcache[k] = jc[k], tc[k]
        else:
            jcache[k] = jcache[k].at[:, :, :n].set(jc[k])
            tcache[k][:, :, :n] = tc[k]
    feed = rng.integers(1, cfg.vocab_size, (n_steps, b, 1)).astype(np.int32)
    for i in range(n_steps):      # teacher-forced, so a tie does not fork the streams
        cur = np.int32(n + i)
        with mesh:
            jtok, _ = jgreedy.fn(jp, jnp.asarray(feed[i]), jax.tree.map(jnp.copy, jcache),
                                 jnp.asarray(cur))
            jl, jcache = jlogits.fn(jp, jnp.asarray(feed[i]), jcache, jnp.asarray(cur))
        twin = {k: v.clone() for k, v in tcache.items()}
        ttok, _ = tgreedy.fn(tp, torch.from_numpy(feed[i]), twin, torch.tensor(cur))
        tl, tcache = tlogits.fn(tp, torch.from_numpy(feed[i]), tcache, torch.tensor(cur))
        assert ttok.dtype == torch.int32 and ttok.shape == (b,)
        np.testing.assert_array_equal(ttok.numpy(), tl.argmax(-1).numpy())
        np.testing.assert_array_equal(np.asarray(jtok), np.asarray(jl).argmax(-1))
        _close(jl, tl, DEEP_TOL)
        _assert_same_greedy(jl, tl)
