"""The production meshes and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.launch.sharding``) against the JAX package's.

* Every parameter leaf of all ten archs at full width: the port's spec of
  the JAX leaf (``jax.eval_shape(model.init)``) equals JAX's
  ``param_spec``, and the port's spec of each of its own per-layer leaves
  equals JAX's spec of the stacked leaf without its stack dims; on meshes
  (1, 1), (2, 2), (16, 16) and (2, 16, 16).
* ``kv_cache_spec``/``cache_shardings`` on every arch's decode-cache leaves
  at decode_32k's batch and at batch 1, ``batch_shardings`` on the train
  and prefill batches, ``logits_sharding``: equal to JAX's on the same
  meshes (JAX's ``NamedSharding`` stood in by its spec).
* JAX's four rule tests as port cases; ``placements`` as DTensor sees a
  spec; the meshes' shapes and batch axes.
* Four gloo ranks: ``distribute_params`` of gemma3-smoke on a (2, 2)
  ``DeviceMesh``: each rank's local shard of every leaf equals the block of
  the global tensor that the leaf's spec gives it.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import specs as jax_specs
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.specs import (META, abstract_params, prefill_batch_specs,
                                       train_batch_specs)
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models.model import make_model
from torch_rank_fns import distribute_rank


class FakeMesh:
    """A mesh as the JAX rules read it: its ``shape`` mapping."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes():
    return {k: FakeMesh(*v) for k, v in MESHES.items()}


def _key_of(kp):
    return tuple(str(k.key) for k in kp if isinstance(k, jax.tree_util.DictKey))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(jax_make_model(cfg).init, jax.random.PRNGKey(0))
    return cfg, [(_key_of(kp), leaf) for kp, leaf in
                 jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _full(spec, nd):
    return tuple(spec) + (None,) * (nd - len(spec))


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_param_specs_equal_jax_at_full_width(arch):
    """Every leaf, every mesh: the rule on JAX's stacked leaf gives JAX's
    spec; each of the port's per-layer leaves gets that spec without its
    leading stack dims (all None)."""
    jcfg, jleaves = _jax_params(arch)
    cfg = get_config(arch)
    want_by_path = {}
    port = list(shd.tree_key_paths(abstract_params(make_model(cfg))))
    assert {p for p, _ in port} == {p for p, _ in jleaves}
    for name, mesh in _meshes().items():
        for path, leaf in jleaves:
            want = tuple(jshd.param_spec(jcfg, mesh, path, leaf))
            assert shd.param_spec(cfg, mesh, path, leaf) == want, (name, path)
            want_by_path[name, path] = _full(want, leaf.ndim)
        for path, leaf in port:
            full = want_by_path[name, path]
            got = _full(shd.param_spec(cfg, mesh, path, leaf), leaf.dim())
            lead = len(full) - len(got)
            assert full[:lead] == (None,) * lead and got == full[lead:], (name, path)


@pytest.fixture
def spec_shardings(monkeypatch):
    """JAX's ``NamedSharding`` as its spec, so the JAX rules run on meshes
    of 256 and 512 devices this process does not have."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_cache_batch_and_logits_specs_equal_jax(arch, spec_shardings):
    """decode_32k's cache at its batch and at batch 1 (``cache_shardings``
    over the port's own cache tree, leaf by leaf against JAX's), the train
    and prefill batches, and the logits, on every mesh."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jmodel, model = jax_make_model(jcfg), make_model(cfg)
    shape = SHAPES["decode_32k"]
    for name, mesh in _meshes().items():
        for b in (shape.global_batch, 1):
            jcache = jax.eval_shape(lambda: jmodel.init_cache(b, shape.seq_len))
            want = jshd.cache_shardings(jcfg, mesh, jcache, b)
            got = shd.cache_shardings(cfg, mesh, model.init_cache(b, shape.seq_len,
                                                                   device=META), b)
            flat_w = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, P))[0]
            flat_j = dict(jax.tree_util.tree_flatten_with_path(jcache)[0])
            n = 0
            for kp, spec in flat_w:
                leaf_got = got
                for k in _key_of(kp):
                    leaf_got = leaf_got[k]
                assert leaf_got == tuple(spec), (name, b, _key_of(kp))
                assert shd.kv_cache_spec(cfg, mesh, b, _key_of(kp)[-1], flat_j[kp]) \
                    == tuple(spec)
                n += 1
            assert n > 0
            assert shd.logits_sharding(cfg, mesh, b) == tuple(jshd.logits_sharding(jcfg,
                                                                                   mesh, b))
        for sname in ("train_4k", "prefill_32k"):
            sh, jsh = SHAPES[sname], JAX_SHAPES[sname]
            port_specs = (train_batch_specs if sh.kind == "train" else prefill_batch_specs)(
                cfg, sh)
            jax_batch = (jax_specs.train_batch_specs if sh.kind == "train"
                         else jax_specs.prefill_batch_specs)(jcfg, jsh)
            want = jshd.batch_shardings(jcfg, mesh, jax_batch, jsh.global_batch)
            got = shd.batch_shardings(cfg, mesh, port_specs, sh.global_batch)
            assert got == {k: tuple(v) for k, v in want.items()}, (name, sname)


# ---------------------------------------------------------------------------
# JAX's four rule tests, as port cases
# ---------------------------------------------------------------------------

def test_param_spec_col_row():
    mesh = pmesh.make_debug_mesh((1, 1))
    assert isinstance(mesh, pmesh.MeshShape)
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    wq = jax.ShapeDtypeStruct((128, 128), jnp.bfloat16)
    assert shd.param_spec(cfg, mesh, ("blocks", "attn", "wq"), wq) == ("data", "model")
    assert shd.param_spec(cfg, mesh, ("blocks", "attn", "wo"), wq) == ("model", "data")


def test_param_spec_divisibility_fallback():
    """hymba's vocab 32001 does not divide 16: that dim stays replicated."""
    mesh = pmesh.make_production_mesh()
    cfg = get_config("hymba-1.5b")
    emb = jax.ShapeDtypeStruct((32001, 1600), jnp.bfloat16)
    spec = shd.param_spec(cfg, mesh, ("head", "embed"), emb)
    assert spec[0] is None and spec[1] == "data"
    assert shd._if_div(mesh, "model", 32001) is None
    assert shd._if_div(mesh, "model", 32000) == "model"


def test_moe_expert_spec():
    mesh = pmesh.make_production_mesh()
    cfg = get_config("phi3.5-moe-42b-a6.6b")     # 2.5 GiB of experts a layer: over 'model'
    w = jax.ShapeDtypeStruct((16, 4096, 6400), jnp.bfloat16)
    assert shd.param_spec(cfg, mesh, ("blocks", "mlp", "w_gate"), w) == ("model", "data", None)
    wd = jax.ShapeDtypeStruct((16, 6400, 4096), jnp.bfloat16)
    assert shd.param_spec(cfg, mesh, ("blocks", "mlp", "w_down"), wd) == ("model", None, "data")
    cfg2 = get_config("olmoe-1b-7b")             # 805 MiB a layer: replicated over 'model'
    assert shd.moe_experts_replicated(cfg2)
    w2 = jax.ShapeDtypeStruct((64, 2048, 1024), jnp.bfloat16)
    assert shd.param_spec(cfg2, mesh, ("blocks", "mlp", "w_gate"), w2) == (None, "data", None)


def test_kv_cache_spec_split_kv():
    """KV heads fewer than the model axis: the sequence over 'model'
    (split-KV decode); enough heads: the heads over 'model'."""
    mesh = pmesh.make_production_mesh()
    leaf = jax.ShapeDtypeStruct((40, 128, 32768, 8, 128), jnp.bfloat16)
    assert shd.kv_cache_spec(get_config("command-r-35b"), mesh, 128, "k", leaf) == \
        (None, "data", "model", None, None)
    leaf2 = jax.ShapeDtypeStruct((32, 128, 32768, 32, 96), jnp.bfloat16)
    assert shd.kv_cache_spec(get_config("phi3-mini-3.8b"), mesh, 128, "k", leaf2)[3] == "model"


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------

def test_production_meshes_match_jax():
    """Without a process group of 256 or 512 ranks the meshes are shape
    records with JAX's axes and sizes; the batch axes are JAX's."""
    assert (pmesh.AXIS_POD, pmesh.AXIS_DATA, pmesh.AXIS_MODEL) == \
        (jmesh.AXIS_POD, jmesh.AXIS_DATA, jmesh.AXIS_MODEL)
    one, two = pmesh.make_production_mesh(), pmesh.make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert two.axis_names == ("pod", "data", "model")
    for m in (one, two, pmesh.make_debug_mesh((2, 2))):
        assert pmesh.batch_axes(m) == jmesh.batch_axes(FakeMesh(tuple(m.shape.values()),
                                                                tuple(m.shape)))
    assert pmesh.axis_sizes(two) == two.shape


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    pod2 = pmesh.make_production_mesh(multi_pod=True)
    assert shd.placements(("data", "model"), pmesh.make_debug_mesh((2, 2))) == \
        (Shard(0), Shard(1))
    assert shd.placements((None, ("pod", "data"), "model"), pod2) == \
        (Shard(1), Shard(1), Shard(2))
    assert shd.placements((), pod2) == (Replicate(),) * 3
    assert shd.placements(("model", None), pod2) == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("data", "pod"), None), pod2)
    pl = shd.param_placements(get_config("gemma3-1b", smoke=True), pmesh.make_debug_mesh((2, 2)),
                              abstract_params(make_model(get_config("gemma3-1b", smoke=True))))
    assert pl["blocks"][0]["attn"]["wq"] == (Shard(0), Shard(1))


def test_distribute_params_on_four_gloo_ranks():
    """gemma3-smoke on a (2, 2) ``DeviceMesh`` of four gloo ranks: every
    leaf's local shard is the block its spec gives the rank."""
    ranks = run_on_ranks(distribute_rank, 4, "gloo", "cpu", args=("gemma3-1b", 0, (2, 2)))
    assert len({(r["checked"], r["sharded_dims"]) for r in ranks}) == 1
    assert ranks[0]["checked"] > 10 and ranks[0]["sharded_dims"] > 10
