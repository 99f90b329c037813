"""The sharded step for every family's smoke config: ``test_torch_sharded_step.py``'s
check (b) on 4 gloo CPU ranks, meshes (2, 2) and (4, 1), against the port's
one-device step (``torch_rank_fns.run_steps`` on both sides, each family's
parameters from the port's seeded init).

olmoe-smoke (the MoE hints, the dispatch and combine on DTensors) runs in the
fast lane; the other eight families under ``slow``.  An MoE mesh step takes
the one-device step's expert choices, and every choice its own router makes
differently must be a near-tie of the one-device router (ROUTER_TIE): the
mesh's sums over 'model' round bf16 at other places.

The repairs the production-mesh dry run needed, against one device and
JAX: microbatches spread over the batch axes (fast lane) and xlstm-smoke's
heads on a 'model' axis that does not divide them (``slow``).
"""

import pytest
import torch

import torch_rank_fns as rf
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models.model import make_model
from test_torch_sharded_step import (MESH_SHAPES, RANKS, assert_ranks_agree,
                                     assert_routing_flips_are_ties, assert_serve_close,
                                     assert_step_close, assert_update_redone, impose_of)

FAST = ["olmoe-1b-7b"]
SLOW = sorted(set(list_archs()) - set(FAST) - {"phi3-mini-3.8b"})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(archs):
    """The one-device records of ``archs``, then one group of ranks that
    runs every (arch, mesh) case."""
    refs, values, cases = {}, {}, []
    for arch in archs:
        values[arch] = rf.params_numpy(make_model(get_config(arch, smoke=True)).init(
            torch.Generator().manual_seed(0)))
        refs[arch] = rf.run_steps(arch, values[arch])
        cases += [(arch, values[arch], m, impose_of(refs[arch]), refs[arch]["fed"])
                  for m in MESH_SHAPES]
    ranks = run_on_ranks(rf.sharded_step_rank, RANKS, "gloo", "cpu", args=(cases,),
                         timeout=1200)
    return {"refs": refs, "values": values, "ranks": ranks, "index": {(c[0], c[2]): i
                                                    for i, c in enumerate(cases)}}


@pytest.fixture(scope="module")
def fast_runs():
    return _runs(FAST)


@pytest.fixture(scope="module")
def slow_runs():
    return _runs(SLOW)


def _check(runs, arch, mesh):
    what = f"{arch} smoke on {mesh}"
    case = runs["index"][arch, mesh]
    ref, ranks = runs["refs"][arch], runs["ranks"]
    assert_ranks_agree(ranks, case, what)
    got = ranks[0]["cases"][case]
    cfg = get_config(arch, smoke=True)
    if cfg.ffn == "moe":
        for phase in ("train", "serve"):
            assert_routing_flips_are_ties(cfg, ref["routing"][phase], got["routing"][phase],
                                          f"{what} {phase}")
    for a in rf.TRAIN_ROWS:
        assert_step_close(ref["train"][a], got["train"][a], f"{what}, {a} microbatches")
        assert_update_redone(arch, runs["values"][arch], got["train"][a],
                             f"{what}, {a} microbatches")
    assert_serve_close(ref, got, what)


@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAST)
def test_moe_sharded_steps_match_one_device(fast_runs, arch, mesh):
    _check(fast_runs, arch, mesh)


@pytest.mark.slow
@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", SLOW)
def test_family_sharded_steps_match_one_device(slow_runs, arch, mesh):
    _check(slow_runs, arch, mesh)


# ---------------------------------------------------------------------------
# The repairs the production-mesh dry run needed, at smoke width: xLSTM's
# heads on a 'model' axis that does not divide them (xlstm-1.3b's 4 heads
# over 16 ranks), and microbatches of fewer rows than a rank's block holds
# (pod2's train_4k: 8 rows a rank, 16 microbatches).  Each against the
# port's one-device step and against ``jax.value_and_grad`` on JAX's
# parameters.
# ---------------------------------------------------------------------------

XLSTM = "xlstm-1.3b"
XLSTM_MESH = (1, 8)      # xlstm-smoke: 4 heads; widths 128 and 256 split 8 ways
SPREAD_ROWS = {4: 8}     # 8 rows in 4 microbatches: 2 rows a rank on 4 batch ranks
# 2-row microbatches over 'data' and replicated over 'pod'; over no axis
SPREAD_MESHES = (((2, 2, 1), ("pod", "data", "model")), ((4, 1), ("data", "model")))


def _jax_values(arch):
    """JAX's smoke parameters of ``arch``, and the same values in the port's
    tree (``run_steps``'s ``values``)."""
    import jax
    import numpy as np

    from repro.configs import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro_torch.core import params_from_numpy

    jm = jax_make_model(jax_get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, rf.params_numpy(params_from_numpy(jax.tree.map(np.asarray, jp),
                                                     get_config(arch, smoke=True),
                                                     device="cpu"))


def _jax_loss_and_grads(arch, jm, jp, rows: int, a: int) -> dict:
    """``jax.value_and_grad(model.loss)`` over ``a`` microbatches (rows
    ``i::a`` of ``step_batch``) on JAX's parameters: the mean loss and the
    f32 gradients, accumulated as JAX's step does, by the port's names."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro_torch.core import params_from_numpy

    cfg = get_config(arch, smoke=True)
    batch = {k: jnp.asarray(v) for k, v in rf.step_batch(cfg, rows).items()}
    grad_fn = jax.value_and_grad(jm.loss, has_aux=True)

    @jax.jit
    def acc(p, b):
        g_acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
        loss = jnp.float32(0.0)
        for i in range(a):
            (l_i, _), g = grad_fn(p, {k: v[i::a] for k, v in b.items()})
            g_acc = jax.tree.map(lambda ga, gi: ga + gi.astype(jnp.float32) / a, g_acc, g)
            loss = loss + l_i / a
        return loss, g_acc

    loss, grads = acc(jp, batch)
    named = {n: p.detach().float().numpy() for n, p in params_from_numpy(
        jax.tree.map(np.asarray, grads), cfg, device="cpu").named_parameters()}
    return {"loss": float(loss), "grads": named}


def _assert_matches_jax(want: dict, got: dict, what: str):
    import numpy as np

    from test_torch_sharded_step import assert_within_ulps
    from test_torch_train_models import LOSS_RTOL

    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{what} loss")
    assert_within_ulps(want["grads"], got["grads"], f"{what} gradients against JAX")


def _repair_runs(arch, rows, serve, cases_of, world):
    """``arch``'s JAX parameters carried over, its one-device record at
    ``rows`` (train steps by microbatches; ``serve``: then the prefill and
    serve steps), the group of ``world`` ranks
    running ``cases_of(values, ref)`` (started in a thread), and JAX's
    gradients computed here meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    jm, jp, values = _jax_values(arch)
    out = {"values": values, "ref": rf.run_steps(arch, values, train_rows=rows, serve=serve)}
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_on_ranks, rf.sharded_step_rank, world, "gloo", "cpu",
                          args=(cases_of(values, out["ref"]),), timeout=1200)
        out["jax"] = {a: _jax_loss_and_grads(arch, jm, jp, b, a) for a, b in rows.items()}
        out["ranks"] = ranks.result()
    return out


@pytest.fixture(scope="module")
def xlstm_runs():
    return _repair_runs(XLSTM, rf.TRAIN_ROWS, True,
                        lambda values, ref: [(XLSTM, values, XLSTM_MESH, None, ref["fed"])], 8)


@pytest.fixture(scope="module")
def spread_runs():
    phi3 = "phi3-mini-3.8b"
    return _repair_runs(phi3, SPREAD_ROWS, False, lambda values, ref: [
        (phi3, values, m, None, None, False, SPREAD_ROWS, axes, False)
        for m, axes in SPREAD_MESHES], RANKS)


@pytest.mark.slow
def test_xlstm_heads_not_dividing_model_match_one_device_and_jax(xlstm_runs):
    """xlstm-smoke on a (1, 8) mesh: its mLSTM and sLSTM run each rank's
    rows with the 4 heads whole (``layers.rows_local``), while the
    projections split 8 ways; the train steps, prefill and serve as
    ``_check`` holds every family, and the gradients within GRAD_ULPS of
    JAX's.  ``slow``: 8 ranks, about 80 s; the fast lane holds
    ``layers.rows_local`` on a mesh through olmoe-smoke's MoE dispatch and
    combine, and xlstm-1.3b's mesh trace in ``test_torch_dryrun.py``."""
    run = xlstm_runs
    what = f"xlstm-smoke on {XLSTM_MESH}"
    assert_ranks_agree(run["ranks"], 0, what)
    got = run["ranks"][0]["cases"][0]
    for a in rf.TRAIN_ROWS:
        assert_step_close(run["ref"]["train"][a], got["train"][a], f"{what}, {a} microbatches")
        assert_update_redone(XLSTM, run["values"], got["train"][a], f"{what}, {a} microbatches")
        _assert_matches_jax(run["jax"][a], got["train"][a], f"{what}, {a} microbatches")
    assert_serve_close(run["ref"], got, what)


@pytest.mark.parametrize("case", range(len(SPREAD_MESHES)),
                         ids=["x".join(map(str, m)) for m, _ in SPREAD_MESHES])
def test_microbatches_spread_over_the_batch_axes_match_one_device_and_jax(spread_runs, case):
    """phi3-smoke, 8 rows in 4 microbatches on 4 batch ranks (2 rows a
    rank): each 2-row microbatch over 'data' and replicated over 'pod' on
    (2, 2, 1), replicated on (4, 1); the train step (no serve steps: the
    layout changes only training) against one device and against JAX's
    accumulated gradients; the ranks that hold the same rows agree."""
    phi3 = "phi3-mini-3.8b"
    run = spread_runs
    what = f"phi3-smoke on {SPREAD_MESHES[case][0]}"
    assert_ranks_agree(run["ranks"], case, what)
    got = run["ranks"][0]["cases"][case]
    for a in SPREAD_ROWS:
        assert_step_close(run["ref"]["train"][a], got["train"][a], f"{what}, {a} microbatches")
        assert_update_redone(phi3, run["values"], got["train"][a], f"{what}, {a} microbatches")
        _assert_matches_jax(run["jax"][a], got["train"][a], f"{what}, {a} microbatches")
        _assert_matches_jax(run["jax"][a], run["ref"]["train"][a], f"one device, {a} microbatches")
