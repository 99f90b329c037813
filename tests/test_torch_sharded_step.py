"""The sharded step (``launch/steps.py`` on a ``DeviceMesh``) against the
port's one-device step and against JAX's step.

(a) ``hint_spec`` equals, for every tag and every mesh of
    ``test_torch_sharding_rules.py``, the spec JAX's ``make_hints`` builds
    (its ``with_sharding_constraint`` and ``NamedSharding`` patched to
    record the spec; nothing in the JAX package changes).
(b) One group of 4 gloo CPU ranks, meshes (2, 2) and (4, 1), phi3-smoke
    (``torch_rank_fns.run_steps``, the same code as the one-device
    reference): a train step at 1 and 2 microbatches, ``assert_step_close``
    (the losses and the drop fraction within LOSS_RTOL, the z-loss within
    Z_RTOL, the gradient norm within NORM_RTOL, the f32 gradients that
    reached AdamW, m and the root of v within GRAD_ULPS bf16 ulps of each
    leaf's largest magnitude: the bounds the port is held to against
    ``jax.value_and_grad``) and ``assert_update_redone`` (the parameters,
    master, m and v those of the one-device AdamW update of the step's own
    gradients and norm, bit for bit); every local shard laid out as its spec
    gives; every replicated leaf's parameter, master, m and v equal on all
    ranks; the prefill and serve steps' logits within DEEP_TOL and their
    greedy tokens equal but at bf16 ties.  (The other families:
    ``test_torch_sharded_families.py``.)
(c) phi3-smoke's sharded train steps against JAX's ``build_train_step`` on
    a (1, 1) mesh on the same parameters (JAX's, carried across), within the
    same bounds, and JAX's own AdamW update of each mesh step's gradients
    equal to the mesh step's, bit for bit.
(d) Checkpoints across layouts: a sharded run's checkpoint holds the full
    state bit for bit and resumes on one device; a one-device run's resumes
    sharded; the same layout resumes bit for bit; each next step is within
    (b)'s bounds of the run that never stopped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_fns as rf
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch import sharding as jshd
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models.model import make_model as jax_make_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, list_archs
from repro_torch.core import params_from_numpy
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.train import checkpoint as ckpt
from test_torch_models import DEEP_TOL
from test_torch_sharding_rules import MESHES, FakeMesh
from test_torch_train_layers import _ulp
from test_torch_train_loop import LR_RTOL, NORM_RTOL, _jax_accumulated_grads
from test_torch_train_models import GRAD_ULPS, LOSS_RTOL

PHI3 = "phi3-mini-3.8b"
# the router's z-loss (the mean of each token's logsumexp squared) on a mesh
# with a 'model' axis: the residual stream carries the row-parallel sums over
# that axis rounded to bf16 twice, and each token's error in lse^2 (std
# 0.012-0.021 measured) comes through the square and the mean over a smoke
# step's 128 tokens: measured up to 7.0e-4 relative (phi3.5-moe-smoke on
# (2, 2), 1 microbatch; olmoe-smoke 1.7e-4), at most 1.3e-7 on (4, 1);
# lb_loss at most 1.5e-4, the drop fraction equal
Z_RTOL = 2 ** -9
MESH_SHAPES = ((2, 2), (4, 1))
RANKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the hint specs
# ---------------------------------------------------------------------------

HINT_SHAPES = {"act": [(4, 64, 128), (6, 64, 128), (16, 8, 3072), (1, 128)],
               "logits": [(4, 64, 512), (16, 32064), (6, 32001), (8, 1, 128)],
               "moe_dispatch": [(4, 8, 16, 128), (16, 64, 40, 2048), (6, 16, 40, 4096)],
               "moe_return": [(4, 4, 16, 128), (32, 16, 40, 4096), (3, 8, 4, 64)]}


def test_hint_specs_equal_jax(monkeypatch):
    """Every tag of JAX's ``make_hints``, on every mesh and every arch (the
    MoE rule reads ``moe_experts_replicated``), at shapes whose dims divide
    the axes and shapes whose dims do not; a tag JAX leaves unconstrained
    (``act`` below 2 dims, an expert buffer that is not 4-d) has no spec."""
    seen = []
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    n = 0
    for arch in list_archs():
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for name, (shape, axes) in MESHES.items():
            mesh = FakeMesh(shape, axes)
            hint = jshd.make_hints(jcfg, mesh, 16)
            for tag, shapes in HINT_SHAPES.items():
                for s in [*shapes, (8,), (4, 8, 16)]:
                    seen.clear()
                    hint(jax.ShapeDtypeStruct(s, jnp.bfloat16), tag)
                    want = seen[0] if seen else None
                    assert shd.hint_spec(cfg, mesh, tag, s) == want, (arch, name, tag, s)
                    n += 1
    assert n > 500


def test_hint_is_identity_without_a_mesh():
    """No hint registered (every one-device path): ``hint`` returns its
    argument itself; a step on a mesh registers it for its call only."""
    from repro_torch.models import layers

    x = torch.ones(2, 3)
    assert layers._HINT["fn"] is None
    assert layers.hint(x, "act") is x
    with layers.sharding_hints(lambda t, tag: None):
        assert layers.hint(x, "act") is None
    assert layers._HINT["fn"] is None and layers.hint(x, "act") is x


# ---------------------------------------------------------------------------
# comparisons shared with test_torch_sharded_families.py
# ---------------------------------------------------------------------------

def assert_within_ulps(want: dict, got: dict, what: str, slack: float = 0.0):
    """Every leaf within GRAD_ULPS bf16 ulps of its largest magnitude (plus
    ``slack``, absolute)."""
    assert set(want) == set(got), what
    for k, w in want.items():
        m = float(np.abs(w).max())
        gap = float(np.abs(w - got[k]).max())
        if m == 0.0:
            assert gap <= slack, (what, k)
            continue
        assert gap <= GRAD_ULPS * _ulp(m) + slack, \
            f"{what} {k}: {gap / _ulp(m):.2f} bf16 ulps (slack {slack:.2e})"


def assert_step_close(want: dict, got: dict, what: str):
    """A train record (``run_steps``'s) against another step's: the losses
    (total, CE, load balance) and the drop fraction within LOSS_RTOL, the
    z-loss within Z_RTOL, the
    gradient norm within NORM_RTOL, the learning rate within LR_RTOL; the
    f32 gradients that reached AdamW within GRAD_ULPS of each leaf's largest
    magnitude (the bound the port is held to against
    ``jax.value_and_grad``), and so m (0.1 x the clipped gradient) and the
    root of v (its magnitude, up to a constant)."""
    wm, gm = want["metrics"], got["metrics"]
    for k in ("loss", "ce_loss", "lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=Z_RTOL if k == "z_loss" else LOSS_RTOL,
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=NORM_RTOL,
                               err_msg=f"{what} grad_norm")
    np.testing.assert_allclose(gm["lr"], wm["lr"], rtol=LR_RTOL, err_msg=f"{what} lr")
    if "grads" in want:
        assert_within_ulps(want["grads"], got["grads"], f"{what} gradients")
    assert_within_ulps(want["m"], got["m"], f"{what} m")
    assert_within_ulps({n: np.sqrt(v) for n, v in want["v"].items()},
                       {n: np.sqrt(v) for n, v in got["v"].items()}, f"{what} root of v")


def assert_update_redone(arch: str, values: dict, got: dict, what: str):
    """The step's AdamW update is the one-device update of its own
    gradients with its own norm (``redo_update``), bit for bit: every
    parameter, master, m and v leaf (a shard skipped, updated twice or with
    another sign, or a master not copied back, shows here)."""
    redo = rf.redo_update(arch, values, got)
    assert redo["lr"] == got["metrics"]["lr"], what
    for k in ("params", "master", "m", "v"):
        assert redo[k].keys() == got[k].keys(), (what, k)
        for n, w in redo[k].items():
            assert np.array_equal(w, got[k][n]), f"{what}: {k} {n} is not the update's"


def assert_tokens_equal_or_tied(logits: np.ndarray, want: np.ndarray, got: np.ndarray,
                                what: str):
    """Greedy tokens equal, but where the reference's logits put the two
    within DEEP_TOL's atol (a bf16 tie either side may break)."""
    rows = np.flatnonzero(want != got)
    gaps = np.abs(logits[rows, want[rows]] - logits[rows, got[rows]])
    assert np.all(gaps <= DEEP_TOL["atol"]), (what, rows, gaps)


def assert_serve_close(ref: dict, got: dict, what: str):
    np.testing.assert_allclose(got["prefill"], ref["prefill"], **DEEP_TOL,
                               err_msg=f"{what} prefill")
    assert_tokens_equal_or_tied(ref["prefill"], np.argmax(ref["prefill"], -1),
                                np.argmax(got["prefill"], -1), f"{what} prefill")
    for i, (w, g) in enumerate(zip(ref["logits"], got["logits"], strict=True)):
        np.testing.assert_allclose(g, w, **DEEP_TOL, err_msg=f"{what} decode {i}")
        assert np.array_equal(got["greedy"][i], np.argmax(g, -1)), (what, i)
        assert_tokens_equal_or_tied(w, ref["greedy"][i], got["greedy"][i], f"{what} {i}")


def assert_ranks_agree(ranks: list, case: int, what: str):
    """Every rank: the same full record; each leaf's local shard as its spec
    lays it out; each replicated leaf's own copy of the parameter, master,
    m and v the same on every rank, bit for bit (one update)."""
    first = ranks[0]["cases"][case]
    for r in ranks:
        rec = r["cases"][case]
        for a, step in rec["train"].items():
            assert step["bad_shards"] == [], (what, a, step["bad_shards"])
            assert step["metrics"] == first["train"][a]["metrics"], (what, a)
            for n, leaf in step["replicated"].items():
                for k, v in leaf.items():
                    assert np.array_equal(v, first["train"][a]["replicated"][n][k]), \
                        (what, a, n, k)
            assert first["train"][a]["replicated"], what
        assert all(np.array_equal(x, y) for x, y in zip(rec.get("logits", []),
                                                        first.get("logits", [])))


def assert_routing_flips_are_ties(cfg, ref_log: list, got_log: list, what: str):
    """Where a mesh step's own router chose other experts than the
    one-device step (whose choices it then took), the one-device router's
    k-th and (k+1)-th probabilities nearly tie (ROUTER_TIE)."""
    from test_torch_moe import ROUTER_TIE

    assert len(ref_log) == len(got_log), what
    for (probs, choice), (_, own) in zip(ref_log, got_log):
        flips = (np.sort(own, -1) != np.sort(choice, -1)).any(-1)
        top = -np.sort(-probs[flips], -1)
        assert np.all(top[..., cfg.moe_top_k - 1] - top[..., cfg.moe_top_k] <= ROUTER_TIE), what


def impose_of(ref: dict) -> dict | None:
    """The one-device record's routing choices, by phase, for the ranks."""
    if not ref["routing"]["train"]:
        return None
    return {k: [c for _, c in v] for k, v in ref["routing"].items()}


# ---------------------------------------------------------------------------
# (b), (c), (d): one group of 4 gloo ranks
# ---------------------------------------------------------------------------

def _jax_params():
    jcfg = jax_get_config(PHI3, smoke=True)
    jm = jax_make_model(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def phi3_runs(tmp_path_factory):
    """JAX's parameters carried into the port; the one-device records; the
    one-device checkpoint run; then the ranks' records."""
    cfg = get_config(PHI3, smoke=True)
    _, _, jp = _jax_params()
    values = rf.params_numpy(params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                               device="cpu"))
    ref = rf.run_steps(PHI3, values)

    d = tmp_path_factory.mktemp("sharded_ckpt")
    one, sharded = d / "one_device", d / "sharded"
    tr, data = rf._trainer(None, one)
    tr.init_state(resume=False)
    tr.run(data, 1, log_every=1)
    one_never_stopped = rf.trainer_step(tr, data)

    cases = [(PHI3, values, m, None, ref["fed"]) for m in MESH_SHAPES]
    cases.append((PHI3, values, MESH_SHAPES[0], None, ref["fed"], True))
    ranks = run_on_ranks(rf.sharded_step_rank, RANKS, "gloo", "cpu",
                         args=(cases, str(one), str(sharded)), timeout=500)
    return {"cfg": cfg, "values": values, "ref": ref, "ranks": ranks, "one": one,
            "sharded": sharded, "one_never_stopped": one_never_stopped}


@pytest.mark.parametrize("case", range(len(MESH_SHAPES)),
                         ids=[f"{a}x{b}" for a, b in MESH_SHAPES])
def test_phi3_sharded_steps_match_one_device(phi3_runs, case):
    what = f"phi3-smoke on {MESH_SHAPES[case]}"
    ranks, ref = phi3_runs["ranks"], phi3_runs["ref"]
    assert_ranks_agree(ranks, case, what)
    got = ranks[0]["cases"][case]
    for a in rf.TRAIN_ROWS:
        assert_step_close(ref["train"][a], got["train"][a], f"{what}, {a} microbatches")
        assert_update_redone(PHI3, phi3_runs["values"], got["train"][a],
                             f"{what}, {a} microbatches")
    assert_serve_close(ref, got, what)


def test_host_staged_collectives_give_the_same_steps(phi3_runs):
    """The (2, 2) case again with every collective through
    ``HostStagedCollectives`` (the transport of gloo ranks sharing a card):
    every number equal to the native gloo run's, each kind of collective
    called."""
    for r in phi3_runs["ranks"]:
        native, staged = r["cases"][0], r["cases"][len(MESH_SHAPES)]
        assert staged["staged_calls"]["all_gather_into_tensor"] > 0
        assert staged["staged_calls"]["reduce_scatter_tensor"] > 0
        assert staged["staged_calls"]["all_reduce"] > 0
        for a in rf.TRAIN_ROWS:
            assert staged["train"][a]["metrics"] == native["train"][a]["metrics"]
            for k in ("grads", "params", "master", "m", "v"):
                for n, v in native["train"][a][k].items():
                    assert np.array_equal(staged["train"][a][k][n], v), (a, k, n)
        for k in ("prefill", "logits", "greedy"):
            assert all(np.array_equal(x, y) for x, y in
                       zip(np.atleast_1d(staged[k]), np.atleast_1d(native[k]))), k


def _jax_tree(jp, named: dict):
    """Leaves by the port's parameter names (numpy) as a tree of JAX's
    layout (``jp``'s), through the port's checkpoint flattening."""
    arrays, _ = ckpt._host({"params": {n: torch.from_numpy(v) for n, v in named.items()}})
    leaves = [jnp.asarray(arrays[k]) for k in jckpt._flatten({"params": jp})]
    return jax.tree.unflatten(jax.tree.structure(jp), leaves)


@pytest.mark.parametrize("microbatches", sorted(rf.TRAIN_ROWS))
def test_phi3_sharded_step_matches_jax(phi3_runs, microbatches, monkeypatch):
    """JAX's ``build_train_step`` on a (1, 1) mesh, on JAX's parameters (the
    ones the ranks carry) and the same batch, against each mesh's step
    (``assert_step_close``; the gradients against the f32 gradients JAX's
    step accumulates); then JAX's own AdamW update (eager, as
    ``test_torch_train_loop.py`` holds the port's) of each mesh step's
    gradients with its norm: the parameters, master, m and v equal the mesh
    step's bit for bit."""
    jcfg, jm, jp = _jax_params()
    cfg = phi3_runs["cfg"]
    b = rf.TRAIN_ROWS[microbatches]
    mesh = jax_debug_mesh((1, 1))
    kw = jax_build_train_step.__kwdefaults__
    step = jax_build_train_step(jm, mesh, JaxShapeSpec("s", rf.STEP_S, b, "train"),
                                microbatches=microbatches)
    batch = {k: jnp.asarray(v) for k, v in rf.step_batch(cfg, b).items()}
    with mesh:
        grads = _jax_accumulated_grads(jm, jp, batch, microbatches)
        _, opt, metrics = step.fn(jax.tree.map(jnp.copy, jp), jax.jit(jopt.adamw_init)(jp),
                                  batch)     # the step donates its parameters

    def named(tree):
        return {n: p.detach().float().numpy() for n, p in
                params_from_numpy(jax.tree.map(np.asarray, tree), cfg,
                                  device="cpu").named_parameters()}

    want = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": named(grads),
            "m": named(opt.m), "v": named(opt.v)}
    for case, shape in enumerate(MESH_SHAPES):
        what = f"JAX against {shape}, {microbatches} microbatches"
        got = phi3_runs["ranks"][0]["cases"][case]["train"][microbatches]
        assert_step_close(want, got, what)
        norm = jnp.float32(got["metrics"]["grad_norm"])
        monkeypatch.setattr(jopt, "global_norm", lambda tree: norm)
        jnew, jst, stats = jopt.adamw_update(
            _jax_tree(jp, got["grads"]), jopt.adamw_init(jp), jp,
            lr_fn=jopt.cosine_schedule(kw["lr"], kw["warmup"], kw["total_steps"]))
        monkeypatch.undo()
        assert float(stats["lr"]) == got["metrics"]["lr"], what
        for k, tree in (("params", jnew), ("master", jst.master), ("m", jst.m), ("v", jst.v)):
            for n, w in named(tree).items():
                assert np.array_equal(w, got[k][n]), f"{what}: {k} {n} is not JAX's update"


def _state_close(want: dict, got: dict, what: str):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL,
                               err_msg=what)
    params = {k: v.astype(np.float32) if v.dtype != np.uint16 else
              (v.astype(np.uint32) << 16).view(np.float32)
              for k, v in want["state"].items() if k.startswith("params/")}
    got_p = {k: v.astype(np.float32) if v.dtype != np.uint16 else
             (v.astype(np.uint32) << 16).view(np.float32)
             for k, v in got["state"].items() if k.startswith("params/")}
    assert_within_ulps(params, got_p, f"{what} params")


def test_checkpoints_cross_layouts(phi3_runs):
    """A sharded checkpoint holds the sharded state in full, bit for bit, in
    the JAX layout; restored on one device, and a one-device checkpoint
    restored on the mesh, each next step is within the bounds of the run
    that never stopped; restored on the same mesh, bit for bit."""
    ranks = phi3_runs["ranks"]
    ck = ranks[0]["ckpt"]
    for r in ranks[1:]:
        assert r["ckpt"]["never_stopped"]["loss"] == ck["never_stopped"]["loss"]
    tr = rf.resume(rf._trainer(None)[0], phi3_runs["sharded"], 1)
    restored = rf.trainer_state(tr)
    assert set(restored) == set(ck["after_1"])
    for k, v in ck["after_1"].items():
        assert np.array_equal(restored[k], v), k
    _, data = rf._trainer(None)
    one_from_sharded = rf.trainer_step(tr, data)
    _state_close(ck["never_stopped"], one_from_sharded, "sharded checkpoint on one device")
    _state_close(phi3_runs["one_never_stopped"], ck["resumed_one_device"],
                 "one-device checkpoint on the mesh")
    same = ck["resumed_sharded"]
    assert (same["loss"], same["grad_norm"]) == (ck["never_stopped"]["loss"],
                                                 ck["never_stopped"]["grad_norm"])
    for k, v in ck["never_stopped"]["state"].items():
        assert np.array_equal(same["state"][k], v), k


def test_step_on_a_mesh_shape_raises():
    """A ``MeshShape`` holds no process group: the builders refuse it."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import make_model

    cfg = get_config(PHI3, smoke=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(make_model(cfg), ShapeSpec("s", 8, 4, "train"),
                         mesh=make_debug_mesh((2, 2)))
